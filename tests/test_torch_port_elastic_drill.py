"""The survive-the-kill drill on the CPU
(`deeplearning4j_tpu_torch/parallel/elastic_smoke.py`, the counterpart of
`scripts/fault_drill.py --elastic-smoke`): 2 worker processes over gloo
train JAX's drill problem (the small Dense net of
`fault_drill.py:212-224`) in threshold mode; rank 1 SIGKILLs itself after
step 3, the survivor re-forms alone from the step-2 checkpoint, the
killed worker is relaunched once the survivor passes step 5 and the
world grows back to 2 until step 10. One drill per file (a module
fixture), inside a wall limit; `run_drill` itself raises on a failed
check, and the tests below read its report.

The drill's two references (the uninterrupted run and the scheduled
one, 2 -> 1 -> 2 replicas in one process) are first held against JAX's:
its threshold `ParallelTrainer` over 2 CPU devices, and its
`ElasticTrainer` over the same schedule with the same stubbed seams, on
the same net, data, batch and seeds, within JAX's bands
(`tests/test_elastic.py`: 0.25 x the initial loss, params atol 0.15)."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.parallel import elastic_smoke

WALL_S = 240.0
#: JAX's bands for threshold sharing (tests/test_elastic.py)
JAX_LOSS_BAND, JAX_PARAM_ATOL = 0.25, 0.15


def _jax_runs(ckpt_dir):
    """JAX's uninterrupted and scheduled runs of the drill problem:
    (losses by iteration, losses by (generation, iteration), final params
    of each as one flat vector)."""
    import jax
    from jax.sharding import Mesh

    from deeplearning4j_tpu.common.updaters import Adam
    from deeplearning4j_tpu.datasets.iterator import ArrayDataSetIterator
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.optimize.listeners import TrainingListener
    from deeplearning4j_tpu.parallel import elastic as jel
    from deeplearning4j_tpu.parallel.trainer import ParallelTrainer

    def net():
        conf = (NeuralNetConfiguration.builder().seed(7)
                .updater(Adam(0.01)).list()
                .layer(DenseLayer(n_in=8, n_out=16, activation="tanh"))
                .layer(OutputLayer(n_in=16, n_out=3, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.feed_forward(8)).build())
        return MultiLayerNetwork(conf)

    def mesh(n):
        return Mesh(np.array(jax.devices()[:n]), ("data",))

    def flat(m):
        return np.concatenate([np.ravel(np.asarray(v)) for v in
                               jax.tree_util.tree_leaves(m.params)])
    x, y = elastic_smoke.dense_data()

    def make_iter():
        return ArrayDataSetIterator(x, y, batch_size=elastic_smoke.E_BATCH,
                                    shuffle=True, seed=11)
    ref, ref_losses = net().init(), {}

    class Collect(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score, **info):
            ref_losses[int(iteration)] = float(score)
    ref.add_listener(Collect())
    ParallelTrainer(ref, mesh(elastic_smoke.N_WORKERS),
                    gradient_sharing="threshold").fit(
        make_iter(), epochs=1, batch_size=elastic_smoke.E_BATCH)

    members, losses = elastic_smoke.ScriptedMembership(), {}

    class InProcess(jel.ElasticTrainer):
        def _init_runtime(self, plan):
            pass

        def _teardown_runtime(self):
            pass

        def _mesh(self, plan):
            return mesh(plan["num_processes"])

    class Script(TrainingListener):
        def __init__(self, generation):
            self.generation = generation

        def iteration_done(self, model, iteration, epoch, score, **info):
            losses[(self.generation, int(iteration))] = float(score)
            if self.generation == 1 and iteration + 1 == elastic_smoke.KILL_AT:
                members.gen = 2
                raise RuntimeError("Connection reset (the scheduled kill)")
            if self.generation == 2 and iteration + 1 == elastic_smoke.HOLD_AT:
                members.gen = 3

    et = InProcess(net, config=jel.ElasticConfig(
        control_address="scripted:0", token="w0"), ckpt_dir=ckpt_dir,
        ckpt_frequency=elastic_smoke.CKPT_FREQUENCY,
        gradient_sharing="threshold")
    et.client = members
    with pytest.raises(RuntimeError, match="scheduled kill"):
        et.fit(make_iter, epochs=1, batch_size=elastic_smoke.E_BATCH,
               extra_listeners=lambda g: [Script(g)])
    model = et.fit(make_iter, epochs=1, batch_size=elastic_smoke.E_BATCH,
                   extra_listeners=lambda g: [Script(g)])
    return ref_losses, losses, flat(ref), flat(model), et.history


def _port_flat(params):
    """The port's {name: array} params in JAX's leaf order (per layer:
    W, then b)."""
    return np.concatenate([np.ravel(params[k]) for k in
                           sorted(params, key=lambda k: (int(k.split("_")[0]),
                                                         k.split("_")[1]))])


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    d = tmp_path_factory.mktemp("drill_refs")
    port = elastic_smoke.references(dict(elastic_smoke.DEFAULTS), str(d))
    jax_runs = _jax_runs(str(d / "jax_ckpts"))
    return port, jax_runs


@pytest.fixture(scope="module")
def drill(refs):
    t0 = time.time()
    # the victim registers again within a few seconds here, so the
    # shrunk world is shorter than the default pack's 5 s hysteresis
    report = elastic_smoke.run_drill(device="cpu", timeout=WALL_S, for_s=1.0,
                                     refs=refs[0])
    report["wall_s"] = time.time() - t0
    return report


@pytest.mark.parametrize("run", ["uninterrupted", "scheduled"])
def test_references_are_jax_s(refs, run):
    """The port's references against JAX's on the same inputs, within
    JAX's bands, before the drill is held to them."""
    port, (j_ref, j_sched, j_ref_p, j_sched_p, j_hist) = refs
    init = j_ref[0]
    if run == "uninterrupted":
        got, want = port["losses"], j_ref
        params, j_params = port["params"], j_ref_p
    else:
        got, want = port["scheduled_losses"], j_sched
        params, j_params = port["scheduled_params"], j_sched_p
        assert [(h["generation"], h["n_workers"], h["step"])
                for h in j_hist] == [(1, 2, 0), (2, 1, 2), (3, 2, 6)]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= JAX_LOSS_BAND * init, (k, got[k], w)
    np.testing.assert_allclose(_port_flat(params), j_params,
                               atol=JAX_PARAM_ATOL)


def test_three_generations_after_one_kill_and_one_relaunch(drill):
    assert drill["generations"] == [1, 2, 3]
    assert drill["widths"] == [2, 1, 2]
    assert drill["wall_s"] < WALL_S
    # the survivor re-formed the world in its own process (on_fatal=
    # "raise", its loop tore the broken group down and joined again):
    # the victim's relaunch is the regrow, no other process restarted
    lives = drill["timeline"]["lives"]
    assert (len(lives["w0"]), len(lives["w1"])) == (1, 2)


def test_losses_hold_jax_s_drift_band(drill):
    ref = drill["reference_losses"]
    init = drill["initial_loss"]
    assert len(ref) == drill["steps"] == 10
    assert drill["max_loss_drift"] <= elastic_smoke.DRIFT_BAND * init
    for token, losses in drill["losses"].items():
        for i, (got, want) in enumerate(zip(losses, ref)):
            if got is None:
                # the killed worker sat out the shrunk generation
                assert token == "w1" and 3 <= i < 6, (token, i)
                continue
            assert abs(got - want) <= elastic_smoke.DRIFT_BAND * init
        assert losses[:2] == pytest.approx(ref[:2], rel=1e-4)


def test_every_resume_restored_the_residual(drill):
    for token, hist in drill["history"].items():
        for h in hist:
            if h["generation"] > 1:
                assert h["resumed"] and h["residual_restored"], (token, h)


def test_no_step_lost_beyond_the_last_checkpoint(drill):
    survivor = drill["history"]["w0"]
    shrunk = [h for h in survivor if h["n_workers"] == 1]
    assert shrunk[0]["step"] == 2           # the checkpoint before the kill
    assert drill["steps_lost"] == 1         # step 3, run again alone
    regrown = [h for hist in drill["history"].values() for h in hist
               if h["generation"] == 3]
    assert {h["step"] for h in regrown} == {6}   # the drain checkpoint


def test_manifests_name_the_writer_world(drill):
    """Checkpoints of the shrunk world name 1 process, the regrown
    world's 2: each resumed what a world of another size wrote."""
    procs = {int(k): v for k, v in drill["manifest_processes"].items()}
    assert procs[elastic_smoke.HOLD_AT] == 1        # the drain, alone
    assert procs[max(procs)] == 2                   # the regrown world
    assert all(v == 1 for k, v in procs.items()
               if elastic_smoke.KILL_AT <= k <= elastic_smoke.HOLD_AT)


def test_final_params_near_the_uninterrupted_run(drill):
    assert drill["final_param_diff"] <= JAX_PARAM_ATOL
    assert drill["reference_device"] == "cpu"


def test_drill_is_the_scheduled_run(drill):
    """Every worker's every step (the killed step's two runs included)
    within LOSS_RTOL of the scheduled run's loss in the same generation,
    the final params within PARAM_MOTION_RTOL of its motion; the drift
    from the uninterrupted run is the schedule's own."""
    assert drill["schedule_loss_rel"] <= elastic_smoke.LOSS_RTOL
    assert drill["param_motion"] <= elastic_smoke.PARAM_MOTION_RTOL
    assert drill["max_loss_drift"] == pytest.approx(
        drill["schedule_drift"],
        abs=2 * elastic_smoke.LOSS_RTOL * max(drill["reference_losses"]))


def test_federated_telemetry_and_alerts_saw_it(drill):
    tel = drill["telemetry"]
    assert "firing" in tel["elastic_shrink"]
    assert tel["elastic_shrink"][-1] == "resolved"
    assert tel["export_age_max_s"]["w1"] > 2.0
    assert tel["victim_returned_after_s"] > 0
    assert tel["elastic_drains_total"] == 1.0
    assert tel["elastic_resume_total"] == 3.0
    # the coordinator counts the regrow and the shrink (and one more
    # commit when the completions' leaves land before the last scrape)
    assert tel["elastic_reconfigurations_total"] >= 2.0
    gens = tel["by_worker"]["elastic_generation"]
    assert (gens["w0"], gens["w1"]) == (3.0, 3.0)
    assert set(tel["workers"]) == {"coordinator", "w0", "w1"}


def test_recovery_timeline_is_split(drill):
    tl = drill["timeline"]
    for part in ("shrink", "regrow"):
        split = tl[part]
        assert all(split[k] >= 0 for k in ("detection_s", "settle_s",
                                           "reinit_s", "resume_s"))
        assert split["total_s"] == pytest.approx(
            split["detection_s"] + split["settle_s"] + split["reinit_s"]
            + split["resume_s"], abs=1e-6)
    assert tl["shrink"]["detection_s"] >= 0.9 * elastic_smoke.GRACE_S
    assert set(tl["ms_per_step"]) == {"1", "2", "3"}
    assert tl["drain_check_host_ms"] > 0
    assert tl["ckpt_writes"] > 0 and tl["ckpt_mb"] > 0
    assert np.isfinite(tl["ckpt_write_s"]) and tl["resume_s"]
    # the survivor saw the broken collective before the coordinator
    # evicted the dead member
    assert tl["shrink"]["survivor_error_s"] < tl["shrink"]["detection_s"]
