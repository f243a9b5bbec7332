"""The JAX package's results at the argv a user types, for the port's
five validation CLIs and four examples, and the one rule that holds the
port's runs to them.

    JAX_PLATFORMS=cpu python tests/torch_cli_refs.py [case ...]

runs ``generate()``: each case of ``CASES`` through the JAX package's
``main`` (``apps/<case>.py`` or ``examples/<case>.py``) on the CPU in
float64, capturing its printed lines, and writes
tests/fixtures/cli_refs.npz (``np.savez_compressed``; with cases named,
only those are re-run and the others kept).  Per case it holds

* ``<case>__argv``: the argv;
* ``<case>__lines`` and ``<case>__labels``: the printed lines, and each
  line with its numbers masked (``label``);
* ``<case>__keys``, ``<case>__values``: the figures ``check_case``
  compares, at full precision, taken from the returned result where it
  has them (``values``);
* ``<case>__field``: an example's returned field;
* ``<case>__wall_s``: the JAX main's wall on the CPU;

and ``jax_version``.  The cases of ``SLOW`` take a minute or more each.

``check_case(name, lines, result, refs)`` is the comparison that
chip_smoke.py applies on the card and tests/test_torch_cli_refs.py on
the CPU.  This module imports jax only inside ``generate()``, and nothing
of either package at import: chip_smoke.py imports it on a machine
without jax.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import io
import pathlib
import re
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FIXTURE = HERE / "fixtures" / "cli_refs.npz"
JAX_PKG = "stabilized_navier_stokes_flow_fenicsx_tpu"
TORCH_PKG = "stabilized_navier_stokes_flow_fenicsx_tpu_torch"

# name: (kind, argv); "app" runs <pkg>.apps.<name>.main(argv), "example"
# runs examples/<name>.py (JAX) or examples/torch_<name>.py (the port)
CASES = {
    "dfg3d": ("app", []),                  # scale 1.5, host LU
    "duct_stokes": ("app", ["12"]),
    "duct_stokes_th": ("app", ["6"]),      # uniform inlet, Schur
    "lid_driven": ("app", ["32", "100"]),
    "dfg2d": ("app", ["0.35"]),
    "poisson_1d": ("example", []),
    "burgers_1d": ("example", []),
    "laplace_2d": ("example", []),
    "laplace_3d": ("example", []),
}
# a minute or more each on the CPU (the Taylor-Hood Schur solve runs its
# 420 outer iterations); the others take seconds (dfg3d ~20 s)
SLOW = ("duct_stokes_th", "lid_driven", "dfg2d")
EXAMPLES = tuple(n for n, (kind, _) in CASES.items() if kind == "example")

# relative bars of check_case: the figures a run must repeat
REL = 1e-6
FIELD_REL = 1e-9        # an example's field, relative L2
KSP_SLACK = 2           # duct_stokes: FGMRES iterations within +-2
PROFILE_ATOL = 1e-4     # duct_stokes: the printed profile error (4 digits)
# lid_driven 32 100: every Newton step's FGMRES stops at its 2000-iteration
# cap (restart 50 x 40 restarts) short of ksp_rtol 1e-5, so near the end
# |F| falls only ~3x a step and lands within 2x of the 1e-8 stop at step 6
# (1.3e-8 to 2.1e-8 over runs whose start differs by 1e-13, or that
# differ only in the card's summation order; profile_torch_cavity.py).
# The stop falls on step 6 or 7 by rounding, and the u_x range is fixed
# only to what |F| ~ 1e-8 leaves: up to 1.2e-6 from JAX's after six steps.
NEWTON_SLACK = 1        # lid_driven: Newton steps within +-1
CAVITY_REL = 3e-6       # lid_driven: the u_x range, relative


def rel_bar(name: str) -> float:
    """The relative bar of case ``name``'s figures (not an example's
    field, which is held to ``FIELD_REL``)."""
    return CAVITY_REL if name == "lid_driven" else REL

_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def label(line: str) -> str:
    """A printed line with every number masked: what the two packages'
    lines must share (the text around the figures, ``True``/``False``,
    and a ``nan`` that stands where a number should)."""
    return _NUMBER.sub("#", line)


def _after(lines, prefix: str) -> float:
    """The figure after ``prefix:`` on the line that starts with it."""
    for line in lines:
        if line.startswith(prefix + ":"):
            return float(line.split(":", 1)[1])
    raise ValueError(f"no line {prefix!r} in {lines}")


def values(name: str, lines, result=None) -> dict:
    """The figures of one run, at full precision: from ``result`` (what
    ``main`` returned) where it has them, else from the printed lines
    (DFG 3D's lines print the repr, so a subprocess's lines give the
    same floats).  An example's only figure is its field (the result)."""
    if name == "dfg3d":
        if result is None:
            return dict(velocity_dofs=_after(lines, "Velocity Degrees of "
                                                    "Freedom"),
                        cl=_after(lines, "Coefficient of Lift"),
                        cd=_after(lines, "Coefficient of Drag"))
        return dict(velocity_dofs=3 * result.mesh.n_nodes,
                    cl=float(result.cl), cd=float(result.cd))
    if name == "duct_stokes":
        return dict(ksp_iters=int(result.ksp_iters),
                    converged=float(bool(result.converged)),
                    inlet_flux=float(result.flux(1)),
                    outlet_flux=float(result.flux(3)),
                    profile_err=_after(lines, "relative L2 error vs "
                                              "developed profile"))
    if name == "duct_stokes_th":
        u = np.abs(np.asarray(result.u).reshape(-1))
        return dict(u_l1=float(u.sum()), u_linf=float(u.max()))
    if name == "lid_driven":
        ux = np.asarray(result.u)[:, 0]
        return dict(newton_iters=int(result.newton_iters),
                    converged=float(bool(result.converged)),
                    ux_min=float(ux.min()), ux_max=float(ux.max()))
    if name == "dfg2d":
        return dict(nodes=int(result.mesh.n_nodes),
                    converged=float(bool(result.converged)),
                    cl=float(result.cl), cd=float(result.cd))
    return {}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check_case(name: str, lines, result, refs) -> list:
    """Hold one run of case ``name`` (its printed ``lines`` and what its
    ``main`` returned; ``result=None`` for a DFG 3D subprocess, the field
    for an example) to the JAX package's (``refs[name]``, as ``load``
    gives it).  Returns rows ``(what, ok, detail)``, every bar of the
    case; the run passes when every row is ok.

    Bars: the same number of lines with the same labels, in every case;
    DFG 3D: the velocity dof count equal, Cd and Cl relative 1e-6 (the
    literature bars are the caller's: they hold at a fine enough scale
    only, and Cl has none on this route, where both packages give 0.104
    at scale 1.5); duct_stokes: converged, FGMRES
    iterations within 2, both fluxes relative 1e-6, the printed profile
    error within 1e-4; duct_stokes_th: the velocity's L1 and Linf norms
    relative 1e-6 (the pressure norms by label only: the rim pressure
    dofs are undetermined); lid_driven: converged, the Newton count
    within 1, the u_x range relative 3e-6 (the stop at |F| <= 1e-8 falls
    on step 6 or 7 by rounding; see ``NEWTON_SLACK``); dfg2d: converged, the node count equal,
    Cd and Cl relative 1e-6; an example: its field relative L2 1e-9, and
    Burgers' first line (Newton iterations, converged) equal."""
    ref = refs[name]
    lines = [str(line) for line in lines]
    want = ref["values"]
    got = values(name, lines, result)
    labels = [label(x) for x in lines]
    same = labels == list(ref["labels"])
    rows = [("printed lines carry the JAX main's labels", same,
             f"{len(lines)} lines" if same
             else f"{labels} vs {list(ref['labels'])}")]

    bar = rel_bar(name)

    def rel(key):
        d = abs(got[key] - want[key])
        r = d / abs(want[key]) if want[key] else (0.0 if not d else np.inf)
        rows.append((f"{key} within relative {bar:g} of JAX's",
                     bool(r <= bar),
                     f"{got[key]!r} vs {want[key]!r} (relative {r:.3e})"))

    def equal(key):
        rows.append((f"{key} equal to JAX's", got[key] == want[key],
                     f"{got[key]!r} vs {want[key]!r}"))

    if name == "dfg3d":
        equal("velocity_dofs")
        rel("cd")
        rel("cl")
    elif name == "duct_stokes":
        equal("converged")
        d = abs(got["ksp_iters"] - want["ksp_iters"])
        rows.append((f"KSP iterations within {KSP_SLACK} of JAX's",
                     d <= KSP_SLACK,
                     f"{got['ksp_iters']} vs {want['ksp_iters']:g}"))
        rel("inlet_flux")
        rel("outlet_flux")
        d = abs(got["profile_err"] - want["profile_err"])
        rows.append((f"printed profile error within {PROFILE_ATOL:g} of "
                     f"JAX's", bool(d <= PROFILE_ATOL + 1e-12),
                     f"{got['profile_err']} vs {want['profile_err']}"))
    elif name == "duct_stokes_th":
        rel("u_l1")
        rel("u_linf")
    elif name == "lid_driven":
        equal("converged")
        d = abs(got["newton_iters"] - want["newton_iters"])
        rows.append((f"Newton steps within {NEWTON_SLACK} of JAX's",
                     d <= NEWTON_SLACK,
                     f"{got['newton_iters']} vs {want['newton_iters']:g}"))
        rel("ux_min")
        rel("ux_max")
    elif name == "dfg2d":
        equal("converged")
        equal("nodes")
        rel("cd")
        rel("cl")
    else:
        field = np.asarray(result, np.float64)
        same = field.shape == ref["field"].shape
        r = _rel(field, ref["field"]) if same else np.inf
        rows.append((f"field within relative L2 {FIELD_REL:g} of JAX's",
                     bool(same and r <= FIELD_REL),
                     f"shape {field.shape} vs {ref['field'].shape}, "
                     f"relative L2 {r:.3e}"))
        if name == "burgers_1d":
            rows.append(("first printed line equal to JAX's",
                         bool(lines[:1] == list(ref["lines"][:1])),
                         f"{lines[:1]} vs {list(ref['lines'][:1])}"))
    return rows


def load(path=FIXTURE) -> dict:
    """The fixture as {case: {argv, lines, labels, values, field,
    wall_s}}, plus ``"jax_version"``."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    refs = {"jax_version": str(data["jax_version"])}
    for name in CASES:
        if f"{name}__argv" not in data:
            continue
        refs[name] = dict(
            argv=[str(a) for a in data[f"{name}__argv"]],
            lines=[str(x) for x in data[f"{name}__lines"]],
            labels=[str(x) for x in data[f"{name}__labels"]],
            values=dict(zip((str(k) for k in data[f"{name}__keys"]),
                            (float(v) for v in data[f"{name}__values"]))),
            field=data.get(f"{name}__field"),
            wall_s=float(data[f"{name}__wall_s"]))
    return refs


def printed(fn, *args, **kwargs):
    """(fn's result, its standard output lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue().splitlines()


def load_example(stem: str):
    """examples/<stem>.py as a module (the directory is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{stem}", ROOT / "examples" / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_case(pkg: str, name: str, argv, **kwargs):
    """``main`` of case ``name`` in package ``pkg`` (the JAX package or
    the port) at ``argv``: (its result, its printed lines, wall)."""
    if CASES[name][0] == "app":
        main = importlib.import_module(f"{pkg}.apps.{name}").main
        call = (lambda: main(list(argv), **kwargs))
    else:
        stem = name if pkg == JAX_PKG else f"torch_{name}"
        main = load_example(stem).main
        call = (lambda: np.asarray(main(**kwargs)))
    t0 = time.perf_counter()
    result, lines = printed(call)
    return result, lines, time.perf_counter() - t0


def generate(cases=None, path=None) -> dict:
    """Run the JAX package's ``main`` for ``cases`` ({name: argv}, or
    names at their ``CASES`` argv; default all) on the CPU in float64,
    and return the references as ``load`` gives them.  With ``path``,
    merge them into the npz there (the cases not run are kept)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    if not isinstance(cases, dict):
        cases = {n: CASES[n][1] for n in (cases or CASES)}
    refs = {"jax_version": jax.__version__}
    for name, argv in cases.items():
        result, lines, wall = run_case(JAX_PKG, name, argv)
        refs[name] = dict(
            argv=list(argv), lines=lines, labels=[label(x) for x in lines],
            values=values(name, lines, result),
            field=(np.asarray(result, np.float64)
                   if CASES[name][0] == "example" else None),
            wall_s=wall)
        print(f"{name} {' '.join(argv)}: {wall:.1f} s, "
              f"{refs[name]['values'] or 'field'}", flush=True)
    if path is not None:
        _write(path, refs)
    return refs


def _write(path, refs) -> None:
    path = pathlib.Path(path)
    old = load(path) if path.exists() else {}
    out = {"jax_version": np.str_(refs["jax_version"])}
    for name in CASES:
        ref = refs.get(name, old.get(name))
        if ref is None:
            continue
        out[f"{name}__argv"] = np.array(ref["argv"], dtype=str)
        out[f"{name}__lines"] = np.array(ref["lines"], dtype=str)
        out[f"{name}__labels"] = np.array(ref["labels"], dtype=str)
        out[f"{name}__keys"] = np.array(list(ref["values"]), dtype=str)
        out[f"{name}__values"] = np.array(list(ref["values"].values()),
                                          dtype=np.float64)
        out[f"{name}__wall_s"] = np.float64(ref["wall_s"])
        if ref["field"] is not None:
            out[f"{name}__field"] = np.asarray(ref["field"], np.float64)
    np.savez_compressed(path, **out)
    print(f"{path}: {path.stat().st_size} bytes", flush=True)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))
    generate(sys.argv[1:] or None, FIXTURE)
