"""A driver with no channel in it: the 1D Poisson problem -u'' = f on
(0, 1), u = 0 at both ends, solved by conjugate gradients in plain
PyTorch, and judged against a dense numpy solve.  It brings its own case
stream, check, judge and control, and shows that an entry needs nothing
of the harness but ``run.py``'s calls."""

from __future__ import annotations

import dataclasses

import numpy as np

TRAFFIC_KEYS = ("entry", "sizes")
LIMIT_KEYS = ("rel_err",)


class ProgramError(RuntimeError):
    """The program departs from the configuration."""


@dataclasses.dataclass(frozen=True)
class ToyCase:
    index: int
    n: int
    seed: int


def check_program(cfg: dict) -> None:
    if cfg["method"] != "cg":
        raise ProgramError(f"the program solves by cg, not {cfg['method']!r}")


def cases(traffic: dict, seed: int):
    sizes = traffic["sizes"]
    order = np.random.default_rng([abs(int(seed)), 0]).permutation(len(sizes))
    i = 0
    while True:
        yield ToyCase(i, int(sizes[order[i % len(sizes)]]), abs(int(seed)))
        i += 1


def round_length(traffic: dict) -> int:
    return len(traffic["sizes"])


def judge_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng([abs(int(seed)), 1])


def prepare(case: ToyCase, workdir: str) -> np.ndarray:
    return np.random.default_rng([case.seed, case.index, 2]).standard_normal(
        case.n)


def _laplacian(n: int) -> np.ndarray:
    return (n + 1) ** 2 * (2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1))


def run(case: ToyCase, rhs: np.ndarray, cfg: dict, device, warm):
    """Conjugate gradients on the tridiagonal operator, matrix-free."""
    import torch

    dtype = getattr(torch, cfg["dtype"])
    b = torch.as_tensor(rhs, dtype=dtype, device=device)
    h2 = float(case.n + 1) ** 2

    def apply(v):
        out = 2 * v
        out[1:] -= v[:-1]
        out[:-1] -= v[1:]
        return h2 * out

    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = torch.dot(r, r)
    stop = cfg["rtol"] ** 2 * float(rr)
    its = 0
    while its < cfg["max_its"] and float(rr) > stop:
        ap = apply(p)
        alpha = rr / torch.dot(p, ap)
        x += alpha * p
        r -= alpha * ap
        rr_new = torch.dot(r, r)
        p = r + (rr_new / rr) * p
        rr = rr_new
        its += 1
    return x, its, float(rr) <= stop


def collect(served, case: ToyCase, captured: dict, workdir: str):
    x, its, converged = served
    return (dict(converged=bool(converged), its=its, n=case.n),
            (case, x.double().cpu().numpy()), None)


def judge(outputs, cfg: dict, limits: dict, rng, device, control,
          per_case=None):
    """The largest relative 2-norm gap to the dense solve; the control
    (``control_edit``) is the program's own float32 solve, so the judge
    takes no notice of it."""
    worst = 0.0
    for case, x in outputs:
        ref = np.linalg.solve(_laplacian(case.n), prepare(case, ""))
        e = float(np.linalg.norm(x - ref) / np.linalg.norm(ref))
        worst = max(worst, e)
        if per_case is not None:
            per_case.append({"rel_err": e})
    return {"rel_err": worst}


def describe(record: dict, judged: dict) -> str:
    return (f"case {record['index']} n {record['n']}: {record['its']} its, "
            f"rel_err {judged['rel_err']:.3g}")


def control_edit() -> dict:
    return {"dtype": "float32"}
