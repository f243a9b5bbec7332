"""The port's examples and profiling helpers, on the CPU.

Each ``examples/torch_*.py`` ``main(device="cpu")`` against its JAX twin
``examples/*.py`` at the default size: fields relative L2 1e-10 and the
same printed lines (the error figures to two digits are part of them
only where they are not roundoff: the Burgers iteration line is
compared, the 1e-13 residual figures are not).  ``main()`` without a
card raises.  ``PhaseTimer`` accumulates and reports; ``device_trace``
does nothing for ``None`` and writes a Chrome trace otherwise.
"""

import importlib.util
import json
import pathlib

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stabilized_navier_stokes_flow_fenicsx_tpu_torch.utils.profiling import (  # noqa: E402
    PhaseTimer, device_trace)

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
    t = PhaseTimer()
    for _ in range(2):
        with t.phase("a"):
            pass
    with pytest.raises(ValueError):
        with t.phase("b"):
            raise ValueError("still timed")
    assert set(t.timings) == {"a", "b"}
    assert all(v >= 0.0 for v in t.timings.values())
    lines = t.report().splitlines()
    assert len(lines) == 2 and lines[0].startswith("a ")
    assert PhaseTimer().report() == ""


def test_device_trace(tmp_path):
    with device_trace(None):
        x = torch.ones(4).sum()
    assert float(x) == 4.0
    assert list(tmp_path.iterdir()) == []
    logdir = tmp_path / "trace"
    with device_trace(str(logdir)):
        torch.ones(8).mul(2.0).sum()
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert any("mul" in e.get("name", "") for e in events)
