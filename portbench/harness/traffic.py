"""The one case generator: a traffic file's parameters and a seed in, the
stream of cases out.

A traffic file (``traffic/<name>.json``) holds:

- ``entry``: the program's entry point that runs each case, the name of
  a driver ``drivers/<entry>.py`` (``run_trace_save``: the solve, the
  checkpoint round trip, the trace and the figures of
  ``apps/inlet_batch.py``);
- ``image``: ``shape`` (one of ``images.SHAPES``; any other is refused),
  ``size`` (pixels) and either ``r_inner`` and ``r_gap`` (``r_outer =
  r_inner + r_gap``), one image for every case, or ``set``, a list of
  ``[r_inner, r_gap]`` pairs that the cases take in turn, in an order
  drawn from the seed (every seed gets the same images, in another
  order);
- ``ratio``: the flow-rate ratio of every case;
- ``reynolds``: ``warmup`` (the untimed first case) and ``cycle`` (the
  timed cases take its values in turn);
- ``warm_start``: whether each case starts its Newton from the previous
  case's solution (the Reynolds sweep's ``warm=``).

Case 0 is the warm-up; the window's cases are 1, 2, ...  The same seed
gives the same cases.  The window closes only at the end of a round
(``round_length`` cases: every image of the set and every Reynolds number
of the cycle equally often), so every window of every seed holds the
same work, in the seed's order.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Iterator, Union

import numpy as np

from . import images


class TrafficError(ValueError):
    """A traffic file the generator cannot serve."""


@dataclasses.dataclass(frozen=True)
class Case:
    index: int
    Re: Union[int, float]
    ratio: float
    shape: str
    size: int
    r_inner: float
    r_outer: float
    warm_start: bool

    @property
    def image_name(self) -> str:
        return f"case{self.index:03d}_{self.shape}.png"


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _seed(seed: int) -> int:
    return abs(int(seed))


def check(traffic: dict) -> None:
    """Refuse what the generator would not serve as the file says."""
    shape = traffic["image"]["shape"]
    if shape not in images.SHAPES:
        raise TrafficError(f"image shape {shape!r}: the harness draws only "
                           f"{images.SHAPES}")
    if not isinstance(traffic["ratio"], (int, float)):
        raise TrafficError(f"ratio {traffic['ratio']!r} is not a number")
    if not isinstance(traffic["entry"], str):
        raise TrafficError(f"entry {traffic['entry']!r} is not a name")


def round_length(traffic: dict) -> int:
    """The cases of one round of the window: each image of the set and
    each Reynolds number of the cycle come equally often in any run of
    this many consecutive window cases."""
    img = traffic["image"]
    return math.lcm(len(img["set"]) if "set" in img else 1,
                    len(traffic["reynolds"]["cycle"]))


def cases(traffic: dict, seed: int) -> Iterator[Case]:
    """The endless case stream of one run."""
    check(traffic)
    img = traffic["image"]
    rng = np.random.default_rng([_seed(seed), 0])
    radii = ([tuple(p) for p in img["set"]] if "set" in img
             else [(img["r_inner"], img["r_gap"])])
    radii = [radii[k] for k in rng.permutation(len(radii))]
    cycle = traffic["reynolds"]["cycle"]
    i = 0
    while True:
        r_in, gap = radii[i % len(radii)]
        Re = (traffic["reynolds"]["warmup"] if i == 0
              else cycle[(i - 1) % len(cycle)])
        yield Case(i, Re, float(traffic["ratio"]), img["shape"],
                   int(img["size"]), r_in, r_in + gap,
                   bool(traffic["warm_start"]) and i > 0)
        i += 1


def judge_rng(seed: int) -> np.random.Generator:
    """The generator of the judge's sample (separate from the cases')."""
    return np.random.default_rng([_seed(seed), 2 ** 20])
