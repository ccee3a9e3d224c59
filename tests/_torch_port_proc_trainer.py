"""The port's ``Trainer(num_hosts=2)`` on member processes
(``ProcessHost``): module-level callables, data and a trainer class
that a spawned member imports by reference, importing torch and the
port only, so a member process imports no JAX.  Not a test module.

The run is ``tests/_torch_port_mesh_train.py``'s (the dryrun GPT in f32,
its numpy weights and six [4, 33] batches, its held-out eval batch); the
test files hand this module the port's half of that case.

The data is pickled afresh for every attempt, so what must happen once
is marked by a file under ``root`` (created with ``O_EXCL``: the first
member to create it acts): ``deaths[(world, step)]`` names the ranks of
a world of that size that die instead of giving that step's batch
(``MemberKilled``, which the feed defers to the step it was read for and
a process member answers by SIGKILLing its own process);
``failures[(world, step)]`` counts host-data failures there (a
``RuntimeError`` of the first members to read it, which the ranks'
agreement raises on every member)."""

import functools
import os
import time

import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel.distributed import WORLD_TIMEOUT_S
from ray_tpu_torch.parallel.gang import MemberKilled, current_member
from ray_tpu_torch.train import Trainer, adam, shard_batch

# the bound on a held member's wait for the owner's marker: a peer's
# collective would wait as long
HOLD_S = WORLD_TIMEOUT_S


def loss(p, b, mesh=None, rules=None, *, cfg):
    return tgpt.loss_fn(p, b, cfg, mesh=mesh,
                        **({} if rules is None else {"rules": rules}))


def evaluate(p, *, cfg, held):
    m = getattr(p["wte"], "device_mesh", None)
    b = {"tokens": held}
    return tgpt.loss_fn(p, shard_batch(b, m) if m is not None else
                        {"tokens": torch.from_numpy(held)}, cfg, mesh=m)


def init_params(seed, *, tree):
    return convert.params_from_numpy(tree, device="cpu")


def _once(path: str) -> bool:
    """True for the first caller, across processes, to claim ``path``."""
    try:
        os.close(os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        return True
    except FileExistsError:
        return False


class ProcBatches:
    """The case's batches on every pass, with the scripted deaths and
    failures of the module note, marked under ``root``."""

    def __init__(self, batches, root: str, deaths=None, failures=None):
        self.batches, self.root = batches, root
        self.deaths = {k: set(v) for k, v in (deaths or {}).items()}
        self.failures = dict(failures or {})

    def __iter__(self):
        me = current_member()
        for i, b in enumerate(self.batches):
            w, step = me.world, i + 1
            if me.rank in self.deaths.get((w, step), ()) and _once(
                    os.path.join(self.root, f"death_w{w}_s{step}_r{me.rank}")):
                raise MemberKilled(f"rank {me.rank} of {w} dies at step "
                                   f"{step}")
            if any(_once(os.path.join(self.root, f"failure_w{w}_s{step}_{n}"))
                   for n in range(self.failures.get((w, step), 0))):
                raise RuntimeError(f"injected data failure at step {step} "
                                   f"in a world of {w}")
            yield b


class HoldingTrainer(Trainer):
    """Every member, after its report of step ``HOLD_AFTER`` (the step
    whose checkpoint rank 0 has written), writes
    ``<storage_path>/held_<rank>`` and waits until the owner has written
    ``<storage_path>/killed`` (bounded by ``HOLD_S``), so that a death
    from outside lands before step ``HOLD_AFTER + 1`` every time, however
    long the steps before took.  The feed reads two batches ahead, so a
    wait in the data at that step would hold the members before the
    checkpoint."""

    HOLD_AFTER = 3

    def train_loop(self, report, get_checkpoint):
        marker = os.path.join(self.storage_path, "killed")

        def held(metrics, *, checkpoint=None):
            report(metrics, checkpoint=checkpoint)
            if metrics["step"] == self.HOLD_AFTER:
                rank = current_member().rank
                with open(os.path.join(self.storage_path, f"held_{rank}"),
                          "w"):
                    pass
                deadline = time.monotonic() + HOLD_S
                while (not os.path.exists(marker)
                       and time.monotonic() < deadline):
                    time.sleep(0.02)

        super().train_loop(held, get_checkpoint)


def proc_trainer(port_case, path: str, data, *, lr: float, steps: int,
                 ckpt_every: int, cls=Trainer, **kw):
    """The port's ``Trainer(num_hosts=2, mesh={"dp": -1})`` on
    ``port_case`` = (port cfg, numpy weights, held-out batch), every
    callable a ``functools.partial`` of a function of this module, eval
    every 3 steps, a report every step, on the CPU."""
    tcfg, tree, held = port_case
    opts = dict(
        loss_fn=functools.partial(loss, cfg=tcfg),
        init_params=functools.partial(init_params, tree=tree),
        optimizer=adam(lr), train_data=data, num_steps=steps,
        eval_fn=functools.partial(evaluate, cfg=tcfg, held=held),
        eval_every=3, report_every=1, checkpoint_every=ckpt_every,
        max_failures=1, storage_path=path, device="cpu", num_hosts=2,
        mesh={"dp": -1}, params_logical=tgpt.param_logical_axes(tcfg))
    return cls(**{**opts, **kw})


class CollectiveLog(Trainer):
    """Records every collective op its train loop dispatches (the
    ``c10d`` and ``_c10d_functional`` namespaces) with the dtype and
    device of its first tensor, in ``<storage_path>/collectives_<pid>``
    (one ``repr`` of a sorted list of (op, dtype, device))."""

    def train_loop(self, report, get_checkpoint):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = set()

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if "c10d" in func.namespace:
                    flat = [a for x in args
                            for a in (x if isinstance(x, (list, tuple))
                                      else (x,))
                            if isinstance(a, torch.Tensor)]
                    seen.add((str(func), str(flat[0].dtype),
                              flat[0].device.type) if flat else
                             (str(func), None, None))
                return func(*args, **(kwargs or {}))

        try:
            with Log():
                super().train_loop(report, get_checkpoint)
        finally:
            path = os.path.join(self.storage_path,
                                f"collectives_{os.getpid()}")
            with open(path, "w") as f:
                f.write(repr(sorted(seen, key=str)))
