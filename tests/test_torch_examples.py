"""The port's examples and profiling helpers, on the CPU.

Each ``examples/torch_*.py`` ``main(device="cpu")`` against its JAX twin
``examples/*.py`` at the default size: fields relative L2 1e-10 and the
same printed lines (the error figures to two digits are part of them
only where they are not roundoff: the Burgers iteration line is
compared, the 1e-13 residual figures are not).  ``main()`` without a
card raises.  The tracer's spans accumulate by name within a case, a
span that raises included; ``device_trace`` does nothing for ``None``
and otherwise writes a Chrome trace with the block's program spans as a
host track.
"""

import importlib.util
import json
import pathlib
import time

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils import (  # noqa: E402
    profiling)
from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.profiling import (  # noqa: E402
    device_trace, span)

from torch_cases import rel_l2  # noqa: E402

torch.set_num_threads(1)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
NAMES = ("poisson_1d", "burgers_1d", "laplace_2d", "laplace_3d")


def _load(stem):
    spec = importlib.util.spec_from_file_location(
        f"_example_{stem}", EXAMPLES / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_example_against_jax(name, capsys):
    u_ref = np.asarray(_load(name).main())
    out_ref = capsys.readouterr().out.splitlines()
    u = np.asarray(_load(f"torch_{name}").main(device="cpu"))
    out = capsys.readouterr().out.splitlines()
    assert u.shape == u_ref.shape
    assert rel_l2(u, u_ref) <= 1e-10
    assert len(out) == len(out_ref)
    # the text before the first figure is the same line by line
    for a, b in zip(out, out_ref):
        assert a.split("=")[0].split(":")[0] == b.split("=")[0].split(":")[0]
    if name == "burgers_1d":
        assert out[0] == out_ref[0]            # Newton iters, converged


@pytest.mark.parametrize("name", NAMES)
def test_example_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _load(f"torch_{name}").main()


def test_phase_timer_accumulates():
    with span("case"):
        a = []
        for _ in range(2):
            with span("a") as s:
                pass
            a.append(s.seconds)
        with pytest.raises(ValueError):
            with span("b") as b:
                raise ValueError("still timed")
    case = profiling.cases()[-1]
    assert set(case.inclusive_s) == {"case", "a", "b"}
    assert case.inclusive_s["a"] == pytest.approx(sum(a), rel=1e-12)
    assert case.inclusive_s["b"] == pytest.approx(b.seconds, rel=1e-12)
    assert all(v >= 0.0 for v in case.self_s.values())
    assert case.n_spans == 4


def test_device_trace(tmp_path):
    with device_trace(None):
        x = torch.ones(4).sum()
    assert float(x) == 4.0
    assert list(tmp_path.iterdir()) == []
    logdir = tmp_path / "trace"
    with device_trace(str(logdir)):
        with span("doubling"):
            time.sleep(0.002)             # margins for the clock's conversion
            torch.ones(8).mul(2.0).sum()
            time.sleep(0.002)
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    mul = [e for e in events if "mul" in e.get("name", "")]
    host = [e for e in events if e.get("cat") == "program"]
    assert mul and [e["name"] for e in host] == ["doubling"]
    # one clock: the host span holds the op it ran
    assert host[0]["ts"] <= mul[0]["ts"]
    assert mul[0]["ts"] + mul[0]["dur"] <= host[0]["ts"] + host[0]["dur"]
