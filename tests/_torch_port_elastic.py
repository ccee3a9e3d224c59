"""The port's elastic ``Trainer(num_hosts=4)`` on in-process gang members
and ``JaxTrainer`` on one device, on the run of
``tests/_torch_port_mesh_train.py`` (the dryrun GPT in f32, six [4, 33]
batches, Adam at 3e-4, a checkpoint every 3 steps).  Not a test module.

The port's data is scripted by the member reading it
(``parallel.gang.current_member()``): ``deaths[(world, step)]`` names the
ranks of a world of that size that kill themselves (``MemberKilled``)
instead of giving that step's batch, once each; ``failures[(world,
step)]`` counts host-data failures there (a ``RuntimeError`` of the
first members to read it, which the ranks' agreement raises on every
member).  The feed raises either at the step it was read for, after the
previous checkpoint.  The JAX side's data fails on the passes given."""

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import _torch_port_mesh_train as mt
from ray_tpu_torch.parallel.gang import MemberKilled, current_member


class GangBatches:
    """The case's batches on every pass, with the scripted deaths and
    failures (see the module note)."""

    def __init__(self, batches, deaths=None, failures=None):
        self.batches = batches
        self.deaths = {k: set(v) for k, v in (deaths or {}).items()}
        self.failures = dict(failures or {})

    def __iter__(self):
        me = current_member()
        for i, b in enumerate(self.batches):
            key = (me.world, i + 1)
            if me.rank in self.deaths.get(key, ()):
                self.deaths[key].discard(me.rank)
                raise MemberKilled(f"rank {me.rank} of {me.world} dies at "
                                   f"step {i + 1}")
            if self.failures.get(key, 0) > 0:
                self.failures[key] -= 1
                raise RuntimeError(f"injected data failure at step {i + 1} "
                                   f"in a world of {me.world}")
            yield b


class PassFailing:
    """The JAX side's data: pass p raises instead of giving step
    ``fails[p]``'s batch."""

    def __init__(self, batches, fails: dict):
        self.batches, self.fails, self.passes = batches, fails, 0

    def __iter__(self):
        self.passes += 1
        stop = self.fails.get(self.passes)
        for i, b in enumerate(self.batches):
            if i + 1 == stop:
                raise RuntimeError(f"injected failure at step {i + 1}")
            yield b


SHRINK = dict(deaths={(4, 4): {1, 3}})
READMIT = dict(deaths={(4, 4): {1, 3}}, failures={(2, 5): 1})


def elastic_trainer(case, path, script, **kw):
    """The port's Trainer on 4 in-process members, {"dp": -1}, with the
    scripted data."""
    opts = dict(num_hosts=4, mesh={"dp": -1}, max_failures=1)
    opts.update(kw)
    return mt.port_trainer(case, path, data=GangBatches(case[3], **script),
                           **opts)


@contextlib.contextmanager
def jax_compile_cache(path: str):
    """JAX's persistent compilation cache in ``path`` meanwhile: each
    JaxTrainer attempt jits its step anew, so the attempts after the
    first read the executables back instead of compiling them again.
    The settings and the cache are restored after."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc

    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    old = {n: getattr(jax.config, n) for n in names}
    for n, v in zip(names, (path, 0, 0)):
        jax.config.update(n, v)
    try:
        yield
    finally:
        for n, v in old.items():
            jax.config.update(n, v)
        cc.reset_cache()


def jax_reference(case, root, jax_fails: dict):
    with jax_compile_cache(os.path.join(root, "jax_cache")):
        return mt.jax_fit(case, {"dp": 1}, os.path.join(root, "jax"),
                          PassFailing(case[3], jax_fails), len(jax_fails))


def run_both(case, root, jax_fails: dict, port_runs: dict):
    """JaxTrainer on one device (data failing per ``jax_fails``) on its
    own thread while ``port_runs`` (name -> () -> value) run here:
    (jax trainer, jax result, {name: value})."""
    with ThreadPoolExecutor(1) as ex:
        jax_run = ex.submit(jax_reference, case, root, jax_fails)
        port = {name: fn() for name, fn in port_runs.items()}
        jtr, jres, _ = jax_run.result()
    return jtr, jres, port


def fit(tr):
    return tr, tr.fit()


def steps_of(reports) -> list:
    return [m["step"] for m in reports]


def same_reports(rec) -> bool:
    """Every member of an attempt reported the same (throughput aside)."""
    lists = [[{k: v for k, v in m.items() if k != "throughput"}
              for m in r] for r in rec["reports"].values()]
    return all(x == lists[0] for x in lists)


def assert_matches_jax(tr, res, jtr, jres):
    """History within rel 1e-4 at every step, the final params (the last
    checkpoint's) within atol 1e-4, the same checkpoint names and
    steps."""
    mt.assert_histories_close(mt.history(res), mt.history(jres))
    final = res.checkpoint.to_dict()
    want = {k: np.asarray(v) if not isinstance(v, dict) else v
            for k, v in jtr.final_state.params.items()}
    mt.assert_params_close(final["params"], _np(want))
    jdir = os.path.join(jres.path, "checkpoints")
    tdir = os.path.join(tr.storage_path, "checkpoints")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in sorted(os.listdir(jdir)):
        from ray_tpu.train import Checkpoint as JaxCheckpoint
        from ray_tpu_torch.train import Checkpoint
        assert Checkpoint(os.path.join(tdir, name)).to_dict()["step"] == \
            JaxCheckpoint(os.path.join(jdir, name)).to_dict()["step"]


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)
