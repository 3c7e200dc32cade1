"""Set-up split by the program's own account: the span trees that the port
keeps of its set-up entries (``ellspmv_tpu_torch/utils/timing.py``,
``setup_log()``), read for one run of the harness.

A run's trees start at the last logged ``formats.auto_from_coo`` tree
whose root has the run's rows and nonzeros and is no longer than the
run's ``convert_s`` (the harness's clock around the same call), and
take every tree logged after it: the first call, HPCG's hierarchy, NPB's
capture. A tree that an earlier run of the process has read is no
later run's. Where there is no such tree (the float32 control, or a
program that keeps no log) every reading is None.

The split of the chooser's tree (`convert_split`): the candidates' work,
each outermost ``formats.price.*`` and ``formats.build.*`` span counted
once with what it holds, on the formats the chooser did not keep
(``convert_discarded_s``) and on the one it kept (``convert_build_s``);
the copies to the card, the outermost ``formats.upload`` spans
(``upload_s``). Then ``first_call_s``, the first ``dispatch.first_call``
tree after it, and ``setup_unspanned_s``, the run's ``setup_s`` less the
seconds of every one of its trees: the part of set-up that no entry of
the program covers.
"""

from __future__ import annotations

#: The root of the chooser's tree.
ROOT = "formats.auto_from_coo"
#: The chooser's work on one candidate: pricing it, building it on the
#: host.
CANDIDATE = ("formats.price.", "formats.build.")

#: (tree, run) for each logged tree a run has read.
_read = []


def log():
    """The port's set-up log, or None where the program keeps none."""
    try:
        from ellspmv_tpu_torch.utils import timing
    except ImportError:
        return None
    setup_log = getattr(timing, "setup_log", None)
    return None if setup_log is None else setup_log()


def run_trees(run) -> list | None:
    """The trees of `run`, the chooser's first; None where there are
    none."""
    trees = log()
    if not trees:
        return None
    _read[:] = [(t, r) for t, r in _read if any(t is u for u in trees)]
    taken = [t for t, r in _read if r is not run]
    trees = [t for t in trees if not any(t is u for u in taken)]
    for i in range(len(trees) - 1, -1, -1):
        spans = trees[i].spans
        if not spans or spans[0].name != ROOT:
            continue
        root = spans[0]
        if (root.attrs.get("rows") == run.n
                and root.attrs.get("nonzeros") == run.nnz
                and root.seconds <= run.convert_s):
            _read.extend((t, run) for t in trees[i:])
            return trees[i:]
    return None


def convert_split(tree) -> dict:
    """The chooser's tree split: ``convert_discarded_s``,
    ``convert_build_s`` and ``upload_s``."""
    choice = tree.spans[0].attrs.get("choice")
    kept = discarded = 0.0
    for i, s in enumerate(tree.spans):
        if s.name.startswith(CANDIDATE) and not any(
                tree.within(i, p) for p in CANDIDATE):
            if s.name.rsplit(".", 1)[1] == choice:
                kept += s.seconds
            else:
                discarded += s.seconds
    return {"convert_discarded_s": discarded, "convert_build_s": kept,
            "upload_s": tree.total_s("formats.upload")}


def split(run) -> dict | None:
    """The five readings of `run` (``first_call_s`` None where no first
    call was logged after the chooser), or None where `run` has no
    trees."""
    trees = run_trees(run)
    if trees is None:
        return None
    out = convert_split(trees[0])
    first = [t for t in trees[1:] if t.spans
             and t.spans[0].name == "dispatch.first_call"]
    out["first_call_s"] = first[0].spans[0].seconds if first else None
    out["setup_unspanned_s"] = run.setup_s - sum(
        t.spans[0].seconds for t in trees if t.spans)
    return out


def reading(run, name: str):
    """One reading of `split`, or None."""
    parts = split(run)
    return None if parts is None else parts[name]

