"""The port's ``Trainer`` on a dp2.tp2 mesh of threaded ranks against
``JaxTrainer`` on the same axes (conftest's CPU devices), through one
failover: the run and the shared tests of
``tests/_torch_port_mesh_train.py`` (the dp2.fsdp2 case is
``tests/test_torch_port_mesh_trainer_fsdp.py``; one file a mesh keeps
each within its time)."""

from _torch_port_mesh_train import (  # noqa: F401 (the shared tests)
    case, runs, test_every_rank_reports_the_same_and_resumes_at_step_3,
    test_mesh_fit_final_params_match_jax_trainer,
    test_mesh_fit_reports_jax_trainers_metrics,
    test_only_rank_0_writes_the_same_checkpoint_steps)

MESH = "dp2_tp2"
