"""The JAX package's results at the argv a user types
(tests/fixtures/cli_refs.npz) and the rule that holds the port to them
(``torch_cli_refs.check_case``, which chip_smoke.py applies on the card).
Float64 on the CPU.

* The fixture holds every case chip_smoke.py runs, at its argv, with
  finite figures, the labels of its lines and the JAX version; DFG 3D's
  default route gives 7,965 velocity dofs and a Cd within the 2% that
  chip_smoke.py asks of the card.
* ``generate()`` re-derives each case from the JAX package and equals the
  fixture to relative 1e-10 (the Taylor-Hood Schur solve, the cavity at
  n=32 and DFG 2D at 0.35 take a minute or more each: ``slow``).
* ``check_case`` accepts the port's own CPU runs (the apps' ``main`` at a
  small argv against the JAX ``main`` at the same argv, DFG 3D from its
  printed lines alone as the card's subprocess gives them; the examples
  through their ``__main__`` block, field saved with ``np.save``, against
  the fixture), and rejects a copy of the references with one figure
  moved past its tolerance or one label changed, while a move well
  inside the tolerance passes.
* The module imports neither jax nor either package.
"""

import copy
import functools
import runpy
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import torch_cli_refs as cli  # noqa: E402

torch.set_num_threads(1)

# argv small enough for the CPU, one per app
SMALL = {"dfg3d": ["3.0"], "duct_stokes": ["6"], "duct_stokes_th": ["3"],
         "lid_driven": ["8", "100"], "dfg2d": ["2.0"]}
# the figure each case's rejection test moves
MOVED = {"dfg3d": "cd", "duct_stokes": "inlet_flux",
         "duct_stokes_th": "u_linf", "lid_driven": "ux_min", "dfg2d": "cl"}


@functools.lru_cache(maxsize=1)
def _fixture():
    return cli.load()


@functools.lru_cache(maxsize=None)
def _port_run(name):
    """(references, printed lines, result) of the port's CPU run of
    ``name``: an app at its small argv, with the JAX ``main`` at the same
    argv as the reference; an example through its ``__main__`` block."""
    if name in cli.EXAMPLES:
        return _fixture(), *_example_main(name)
    refs = cli.generate({name: SMALL[name]})
    result, lines, _ = cli.run_case(cli.TORCH_PKG, name, SMALL[name],
                                    device="cpu")
    # the card runs DFG 3D as a subprocess and has its lines only
    return refs, lines, None if name == "dfg3d" else result


def _example_main(name):
    """Run examples/torch_<name>.py as ``python3 examples/... u.npy``
    does, with the assembler's default device made the CPU: (lines,
    the saved field)."""
    import tempfile

    from stabilized_navier_stokes_flow_fenicsx_tpu_torch.assemble import (
        assembly)

    path = cli.ROOT / "examples" / f"torch_{name}.py"
    with tempfile.TemporaryDirectory() as tmp, \
            pytest.MonkeyPatch.context() as mp:
        out = f"{tmp}/u.npy"
        mp.setattr(assembly, "default_device", lambda: torch.device("cpu"))
        mp.setattr(sys, "argv", [str(path), out])
        _, lines = cli.printed(runpy.run_path, str(path),
                               run_name="__main__")
        return lines, np.load(out)


def _failed(rows):
    return [what for what, ok, _ in rows if not ok]


def test_fixture_holds_every_case():
    refs = _fixture()
    assert refs["jax_version"]
    assert cli.FIXTURE.stat().st_size < 150_000
    for name, (kind, argv) in cli.CASES.items():
        ref = refs[name]
        assert ref["argv"] == argv
        assert ref["lines"] and ref["labels"] == [cli.label(x)
                                                  for x in ref["lines"]]
        assert all(np.isfinite(v) for v in ref["values"].values())
        assert ref["wall_s"] > 0
        if kind == "example":
            assert ref["field"].ndim == 1 and np.isfinite(ref["field"]).all()
        else:
            assert ref["values"] and ref["field"] is None


def test_fixture_dfg3d_default_route():
    """DFG 3D with no argv: scale 1.5 by the host LU, 7,965 velocity
    dofs, Cd within the 2% of 6.18533 that chip_smoke.py asks of the
    card; its Cl lies far above the literature's 0.009401 in the JAX
    package as in the port, so the card holds Cl to JAX's value only."""
    v = _fixture()["dfg3d"]["values"]
    assert v["velocity_dofs"] == 7965
    assert abs(v["cd"] - 6.18533) / 6.18533 < 0.02
    assert v["cl"] > 3.5 * 0.009401


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n in cli.SLOW else n
    for n in cli.CASES])
def test_generate_matches_fixture(name):
    want = _fixture()[name]
    got = cli.generate([name])[name]
    assert got["argv"] == want["argv"]
    assert got["labels"] == want["labels"]
    assert list(got["values"]) == list(want["values"])
    for key, v in got["values"].items():
        assert abs(v - want["values"][key]) <= 1e-10 * abs(
            want["values"][key]), (key, v, want["values"][key])
    if want["field"] is not None:
        assert cli._rel(got["field"], want["field"]) <= 1e-10


@pytest.mark.parametrize("name", list(cli.CASES))
def test_check_case_accepts_the_port(name):
    refs, lines, result = _port_run(name)
    rows = cli.check_case(name, lines, result, refs)
    assert len(rows) >= 2
    assert not _failed(rows), rows


def _moved(refs, name, factor):
    refs = copy.deepcopy(refs)
    if name in cli.EXAMPLES:
        refs[name]["field"] = refs[name]["field"] * factor
    else:
        refs[name]["values"][MOVED[name]] *= factor
    return refs


@pytest.mark.parametrize("name", list(cli.CASES))
def test_check_case_rejects_a_moved_number(name):
    refs, lines, result = _port_run(name)
    tol = cli.FIELD_REL if name in cli.EXAMPLES else cli.rel_bar(name)
    assert not _failed(cli.check_case(name, lines, result,
                                      _moved(refs, name, 1 + tol / 10)))
    failed = _failed(cli.check_case(name, lines, result,
                                    _moved(refs, name, 1 + 10 * tol)))
    assert len(failed) == 1
    assert (name in cli.EXAMPLES and "field" in failed[0]) \
        or MOVED.get(name, "?") in failed[0]


@pytest.mark.parametrize("name", list(cli.CASES))
def test_check_case_rejects_a_changed_label(name):
    refs, lines, result = _port_run(name)
    refs = copy.deepcopy(refs)
    refs[name]["labels"][-1] += " (changed)"
    assert _failed(cli.check_case(name, lines, result, refs)) == [
        "printed lines carry the JAX main's labels"]


def test_check_case_counts():
    """The two bars that are not relative: duct_stokes' FGMRES count
    within 2, the cavity's Newton count within 1."""
    refs, lines, result = _port_run("duct_stokes")
    moved = copy.deepcopy(refs)
    moved["duct_stokes"]["values"]["ksp_iters"] += 2
    assert not _failed(cli.check_case("duct_stokes", lines, result, moved))
    moved["duct_stokes"]["values"]["ksp_iters"] += 1
    assert _failed(cli.check_case("duct_stokes", lines, result, moved))
    refs, lines, result = _port_run("lid_driven")
    moved = copy.deepcopy(refs)
    moved["lid_driven"]["values"]["newton_iters"] += 1
    assert not _failed(cli.check_case("lid_driven", lines, result, moved))
    moved["lid_driven"]["values"]["newton_iters"] += 1
    assert _failed(cli.check_case("lid_driven", lines, result, moved)) == [
        "Newton steps within 1 of JAX's"]


def test_label_masks_the_numbers():
    assert cli.label("KSP iters: 437, converged: True") == \
        "KSP iters: #, converged: True"
    assert cli.label("inlet flux 0.983684  outlet flux -1.5e-03") == \
        "inlet flux #  outlet flux #"
    assert cli.label("Coefficient of Lift: nan") == "Coefficient of Lift: nan"


def test_module_imports_no_jax():
    code = ("import sys; sys.path.insert(0, 'tests'); import torch_cli_refs;"
            " bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'stabilized_navier_stokes_flow_fenicsx_tpu')]; "
            "assert not bad, bad; torch_cli_refs.load()")
    subprocess.run([sys.executable, "-c", code], cwd=cli.ROOT, check=True,
                   timeout=120)
