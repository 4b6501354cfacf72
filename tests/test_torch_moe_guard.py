"""MoE serving through the port against the reference, split from
``tests/test_torch_moe_serve.py`` (its helpers and tolerances) so that
the driver's ``--dist loadfile`` spreads the reference's compiles: the
numeric guard's re-decode through MoE weights hoisted per rung
(granite-moe smoke), whose poisoned streams equal the reference's."""
import pytest

pytest.importorskip("torch")

from repro.serve.faults import Fault as JFault  # noqa: E402
from repro.serve.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro_torch.serve import Fault, FaultPlan  # noqa: E402
from test_torch_moe_serve import (MAX_LEN, _prompts,  # noqa: E402,F401
                                  _serve_both, pair)
from _torch_threads import torch_threads  # noqa: E402,F401


def test_poisoned_streams_equal_reference(pair):
    """A poisoned slot re-decoded up the guard's ladder (posit16, then
    full precision): each rung's MoE expert weights hoisted from the raw
    parameters."""
    spec = [dict(kind="poison_logits", at=3, slot=0, fixed_by_level=2)]
    plans = (JFaultPlan(tuple(JFault(**d) for d in spec)),
             FaultPlan(tuple(Fault(**d) for d in spec)))
    (je, jr, _), (te, tr, _) = _serve_both(
        pair, _prompts(pair[1].vocab)[:3],
        dict(max_batch=2, max_len=MAX_LEN), faults=plans, guard=True)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.done and r.error is None for r in tr)
    c = te.metrics.snapshot()["counters"]
    assert c["guard.fallbacks"] == 2 and c["guard.quarantined"] == 1
    (uid,) = te.faults.uids_poisoned
    assert te.guard.level(uid) == je.guard.level(uid) == 2
