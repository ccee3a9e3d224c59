"""How a ``Trainer(num_hosts=2)`` hosts its members: a spec that cannot
travel to a member process (its loss is a closure) keeps the gang's
members in this process (the in-process host), logs one warning naming
the loss and records ``"in-process"`` in every attempt; the callables and
data of ``tests/_torch_port_proc_trainer.py`` travel; and on member
processes a ``{"dp": -1}`` step's collectives are all-reduces and
barriers only."""

import ast
import logging
import os

import _torch_port_mesh_train as mt
import _torch_port_proc_trainer as pt
from _torch_port_mesh_train import case  # noqa: F401 (the fixture)
from ray_tpu_torch.parallel.gang import (InProcessHost, ProcessHost,
                                         cannot_travel)


def test_a_closure_keeps_the_members_in_this_process(case, tmp_path, caplog):
    _, tcfg, tree, _, held = case
    path = str(tmp_path)

    def closure_loss(p, b, mesh=None, rules=None):
        return pt.loss(p, b, mesh, rules, cfg=tcfg)

    tr = pt.proc_trainer(
        (tcfg, tree, held), path, pt.ProcBatches(case[3][:2], path),
        lr=mt.LR, steps=2, ckpt_every=2, loss_fn=closure_loss)
    with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.train"):
        res = tr.fit()
        tr.fit()
    assert [a["host"] for a in tr.attempts] == ["in-process"] * 2
    assert isinstance(tr.gang.host, InProcessHost)
    assert not isinstance(tr.gang.host, ProcessHost)
    assert tr.gang.member_pids() == [os.getpid()] * 2
    warned = [r.getMessage() for r in caplog.records
              if "cannot travel" in r.getMessage()]
    assert len(warned) == 1 and "loss_fn" in warned[0]
    assert "closure_loss" in warned[0]
    assert [m["step"] for m in res.metrics_history] == [1, 2]


def test_what_travels_to_a_member_process(case, tmp_path):
    """``cannot_travel``: module-level functions and classes, their
    ``functools.partial``s and numpy data travel; a lambda, a closure and
    a generator do not, and say why."""
    _, tcfg, tree, batches, held = case
    tr = pt.proc_trainer((tcfg, tree, held), str(tmp_path),
                         pt.ProcBatches(batches, str(tmp_path)), lr=mt.LR,
                         steps=2, ckpt_every=2)
    for name, value in tr._member_config().items():
        assert cannot_travel(value) is None, name
    assert cannot_travel(pt.HoldingTrainer) is None

    def local(rank):
        return rank

    for value in (lambda rank: rank, local, (b for b in batches),
                  {"loss": local}):
        assert cannot_travel(value) is not None, value


def test_a_dp_step_on_processes_issues_only_all_reduces(case, tmp_path,
                                                         monkeypatch):
    """Two member processes (gloo) run two steps and a checkpoint of the
    dryrun GPT on ``{"dp": -1}``: every collective their loops dispatch
    is an all-reduce or the checkpoint manager's barrier, as
    ``parallel/distributed.py``'s note says (the list that gloo must
    take over CUDA tensors on the card)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # one thread a member
    _, tcfg, tree, batches, held = case
    path = str(tmp_path)
    tr = pt.proc_trainer((tcfg, tree, held), path,
                         pt.ProcBatches(batches[:2], path), lr=mt.LR,
                         steps=2, ckpt_every=2, cls=pt.CollectiveLog)
    try:
        tr.fit()
        pids = tr.gang.member_pids()
    finally:
        tr.gang.shutdown()
    assert [a["host"] for a in tr.attempts] == ["process"]
    logs = [ast.literal_eval(open(os.path.join(path, f"collectives_{p}"))
                             .read()) for p in pids]
    assert logs[0] == logs[1]
    ops = {op for op, _, _ in logs[0]}
    assert ops == {"c10d.allreduce_.default", "c10d.barrier.default",
                   "_c10d_functional.all_reduce.default",
                   "_c10d_functional.wait_tensor.default",
                   "_c10d_functional._wrap_tensor_autograd.default"}, ops
    assert {(op, dt) for op, dt, _ in logs[0] if "reduce" in op} == {
        ("c10d.allreduce_.default", "torch.int64"),
        ("_c10d_functional.all_reduce.default", "torch.float32")}
