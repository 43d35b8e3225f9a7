"""The whole sequential per-goal path with compaction: ``optimize(fused=True,
pipeline=False, fuse_group_size=1)`` on the skewed 16-broker model of
tests/test_frontier.py:51 with the stack of tests/test_pipeline.py:42 and
the dense floor lowered to 8 in both packages, in the PyTorch port against
the JAX package.  Per goal the same packed slots and chunk records, the
same goals skipped by the satisfied-sweep, the same placement; the run
compacts and speculates.  (At 16 brokers ``pipeline=False`` alone keeps
the JAX package's grouped stack, below its 100-broker per-goal default:
``fuse_group_size=1`` selects the per-goal path.)"""

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu_torch.analyzer import optimizer as topt
from tests.torch_port_helpers import clear_cruise_env, compare_per_goal, skewed_models

PIPELINE_STACK = ["RackAwareGoal", "ReplicaDistributionGoal",
                  "LeaderReplicaDistributionGoal"]


def test_per_goal_path_compacts_like_the_jax_package(monkeypatch):
    clear_cruise_env(monkeypatch)
    monkeypatch.setattr(jopt, "_FRONTIER_DENSE_MIN", 8)
    monkeypatch.setattr(topt, "_FRONTIER_DENSE_MIN", 8)
    jm, tm = skewed_models(7)
    # The skew recipe relocates replicas without regard to their siblings,
    # so the starting placement is not one verify_run accepts as "old".
    _, trun = compare_per_goal(jm, tm, PIPELINE_STACK, verify=False, pipeline=False,
                               fuse_group_size=1, segment_steps=2)
    chunks = [c for g in trun.goal_results for c in (g.chunks or [])]
    assert any(c["bucket"] == 8 for c in chunks)
    # The compacted chunk's follow-up was dispatched, then discarded.
    assert sum(g.chunks_speculative for g in trun.goal_results) > 0
    assert sum(g.chunks_wasted for g in trun.goal_results) > 0
