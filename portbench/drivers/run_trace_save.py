"""Driver of ``apps/inlet_batch.py::run_trace_save``: the solve, the
checkpoint round trip, the trace and the figures of one case.

A driver is found by the ``entry`` of a traffic file and gives the
harness (``run.py``, ``control.py``) everything that belongs to its
program path:

- ``check_program(cfg)``: raises ``RunError`` when the program departs
  from the configuration;
- ``cases(traffic, seed)``, ``round_length(traffic)`` and
  ``judge_rng(seed)``: the stream of cases (case 0 warms up), the cases
  of one round (the window closes at a round's end) and the generator
  of the judge's sample;
- ``prepare(case, workdir)``: the case's untimed inputs;
- ``run(case, prepared, cfg, device, warm)``: the call the harness
  times; ``warm`` is what the last ``collect`` handed on;
- ``collect(served, case, captured, workdir)``: (the record's fields,
  the output the judge compares, the next case's ``warm``), untimed;
  the fields hold ``converged`` (the case gave its answer) and may
  hold ``folder``, which the harness deletes after the warm-up and the
  profiled case;
- ``judge(outputs, cfg, limits, rng, device, control, per_case)``: the
  numbers that decide ``correct``, each the worst over the window's
  outputs, with each case's appended to ``per_case``; ``control``
  (``control_edit()``'s, else None) puts the control in the program's
  place;
- ``describe(record, judged)``: a judged case's line on standard error;
- ``control_edit()``: the control's keys, merged into the configuration
  and handed to ``judge``;
- ``TRAFFIC_KEYS`` and ``LIMIT_KEYS``: what its traffic and limits files
  hold.

Here the check, the stream and the control are the channel's
(``harness/channel_entry.py``); the judge is ``harness/judge.py``'s.
"""

from __future__ import annotations

import os

from portbench.harness import channel_entry as channel
from portbench.harness import images
from portbench.harness import judge as channel_judge

TRAFFIC_KEYS = ("entry", "image", "ratio", "reynolds", "warm_start")
LIMIT_KEYS = ("residual", "trace_end_err", "geometry_err", "reverse_sample",
              "outlet_band")

check_program = channel.check_program
cases = channel.cases
round_length = channel.round_length
judge_rng = channel.judge_rng
control_edit = channel.control_edit


def prepare(case, workdir: str) -> str:
    """The case's inlet image, drawn into the run's folder."""
    return images.make_annulus_image(
        os.path.join(workdir, case.image_name), case.size, case.r_inner,
        case.r_outer)


def run(case, image: str, cfg: dict, device, warm):
    """One call of ``run_trace_save``, from the last case's solution
    where the traffic starts warm; returns (solution, trace result,
    output folder)."""
    return channel.run_trace_save(case, image, cfg, device,
                                  warm if case.warm_start else None)


def collect(served, case, captured: dict, workdir: str):
    """(record fields, ``judge.CaseOutput``, the solution)."""
    sol, res, folder = served
    fields = channel.solve_fields(sol, res, case)
    fields["folder"] = os.path.join(workdir, folder)
    return fields, channel.solve_output(sol, res, case, captured), sol


def judge(outputs, cfg: dict, limits: dict, rng, device, control,
          per_case=None):
    """``harness/judge.py::judge`` of every window case."""
    return channel_judge.judge(
        outputs, cfg, limits, rng, device,
        None if control is None else control["trace_dtype"],
        per_case=per_case)


def describe(record: dict, judged: dict) -> str:
    """The line of a judged case on standard error."""
    fine = [f"{row[0]:.3g}" for row in record["history"].get("fine_ns", [])]
    return (f"case {record['index']} Re {record['Re']}: "
            f"{record['wall_s']:.3f} s, converged {record['converged']}, "
            f"fine Newton |F| {fine}, "
            + ", ".join(f"{k} {v:.4g}" for k, v in judged.items()))
