"""Progress visitor protocol.

Mirrors the reference visitor contract (ref:src/super4pcs/algorithms/
match4pcsBase.h:73-76, hpp:232-252, hpp:458-465): a callable
``visitor(fraction, best_lcp, transform)`` invoked

- once at loop start with fraction 0,
- after every device step with fraction = max(trial, time) progress,
- with fraction = -1 for every candidate improvement inside a step
  (the Meshlab plugin's live-update path,
  ref:demos/MeshlabPlugin/.../globalregistration.cpp:107-133).

``needs_global_transformation()`` selects whether the visitor receives
the centered-frame transform or the recomposed original-frame one.

A copy of ``super4pcs_tpu.visitor``, less its fused-dispatch
granularity: the port's one anytime loop calls the visitor once a step
at every size.
"""

from __future__ import annotations


class DummyTransformVisitor:
    """No-op visitor (ref:match4pcsBase.h DummyTransformVisitor)."""

    def __call__(self, fraction, best_lcp, transform):
        pass

    def needs_global_transformation(self) -> bool:
        return False


class PrintingTransformVisitor:
    """CLI progress visitor (ref:demos/Super4PCS/super4pcs_test.cc:29-42):
    prints ``done: N% best: lcp`` on a carriage-return line."""

    def __call__(self, fraction, best_lcp, transform):
        if fraction >= 0:
            print(f"done: {int(fraction * 100)}% best: {best_lcp:f}"
                  "                  ", end="\r", flush=True)

    def needs_global_transformation(self) -> bool:
        return False


def visitor_needs_global(visitor) -> bool:
    fn = getattr(visitor, "needs_global_transformation", None)
    return bool(fn()) if callable(fn) else False
