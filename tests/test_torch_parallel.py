"""Data parallel on the CPU: two gloo ranks against one process over the
global batch (port only, fp32; the BatchNorm also against flax).

One `torch.multiprocessing` start of two ranks per module (forked from a
server that has imported the port once; a FileStore, no TCP port to race
for) runs every two-rank scenario in turn and pickles its results; the
parent computes the single-process references meanwhile; the tests
compare:
global-batch BatchNorm statistics, the gradient all-reduce, a
`train_step` + `graph_step` of the tiny 32x32 trainer, the global NaN
skip, `check_model` over unequal val slices (IoU and fidelity score)
and the training CLI's rank-0 writes. The launch
variables and the model axis are checked in-process.
"""

import datetime
import json
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from threadpoolctl import threadpool_limits

from ag2video_torch.data.registry import Loader, get_dataset
from ag2video_torch.eval.backbone import (DEFAULT_WEIGHTS, FidelityScore,
                                          load_backbone)
from ag2video_torch.models.normalization import BatchNorm
from ag2video_torch.parallel import (allreduce_grads, data_scope,
                                     init_distributed, make_mesh)
from ag2video_torch.parallel.mesh import (LAUNCH_VARS,
                                          gather_in_split_order,
                                          replicas_differ, state_tensors)
from ag2video_torch.scripts import train as train_cli
from ag2video_torch.train import Trainer
from ag2video_torch.train import checkpoint as ckpt_lib
from tests.test_torch_fit import TINY, make_cfg

WORLD = 2
# Two ranks' sums against one process's means: summation order only.
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
# The tiny trainer against one process: the losses within LOSS_RTOL of
# max(|loss|, 1); the first step's gradients per parameter by rel-L2
# against max(its norm, ZERO_GRAD_REL x its network's largest), the worst
# within STEP_GRAD_WORST and the median within STEP_GRAD_MEDIAN; the
# parameters after the step within PARAM_ATOL; the BN running statistics
# within STATE_TOL. Summation order alone moves the gradients: one process
# whose global batch is permuted differs from itself by 6.4e-3 per
# parameter at worst (median 9.3e-4), two ranks from one process by 4.7e-3
# (6.4e-4); the losses by 5.4e-7 and 1.1e-6. The graph step's gradients
# (no BatchNorm on that path) within GRAPH_GRAD_REL each (measured
# 9.9e-8). Each parameter takes one Adam step (the G, D or graph Adam),
# which moves an element by about lr whatever its gradient, so PARAM_ATOL
# guards only against a gross change (a missed or doubled step); the
# gradients above hold the all-reduce. The tests below fail on each of
# five mutations: local BatchNorm statistics, local gradients, a local NaN
# decision, and the graph step reducing D's gradients instead of G's or
# doubling them on every rank.
LOSS_RTOL = 1e-5
STEP_GRAD_WORST = 2e-2
STEP_GRAD_MEDIAN = 3e-3
GRAPH_GRAD_REL = 1e-5
ZERO_GRAD_REL = 1e-4
PARAM_ATOL = 2.5 * TINY["learning_rate"]
VAL_SAMPLES = 5
# The trainer's comparisons use the instance-norm SPADE. With the default
# syncbatch SPADE the tiny generator's 1x1 SPADE head normalises 4 nearly
# equal values a channel, and rounding is amplified: one process moves its
# total loss by 2.2e-3 and its G gradients by 0.22 rel-L2 when its global
# batch is permuted, and two ranks land as far from it. With the instance
# norm a permutation moves the losses by <= 1e-6. Eight BatchNorms keep
# the global statistics on this path (the flow net's six, flow_down_0 and
# conv_dim_in); test_batchnorm_stats_are_global holds the BatchNorm
# itself.
DP_CFG = dict(norm_G="spectralspadeinstance3x3")
SPAWN_TIMEOUT_S = 300


def _bn_inputs():
    rng = np.random.RandomState(0)
    x = (rng.randn(16, 8, 8, 4) + 0.5 * rng.randn(4)).astype(np.float32)
    return x, rng.randn(*x.shape).astype(np.float32)


def _bn_run(x, w, scope=None):
    """Port BatchNorm(4) in train mode on x -> (out, running mean, running
    var, gradient of sum(out * w) w.r.t. x)."""
    bn = BatchNorm(4)
    xt = torch.from_numpy(x).requires_grad_(True)
    with data_scope(scope):
        y = bn(xt, train=True)
    (y * torch.from_numpy(w)).sum().backward()
    return (y.detach().numpy(), bn.running_mean.numpy(),
            bn.running_var.numpy(), xt.grad.numpy())


def _linear_inputs():
    rng = np.random.RandomState(1)
    return tuple(rng.randn(*shape).astype(np.float32)
                 for shape in ((4, 8), (4,), (16, 8), (16, 4)))


def _linear_grads(W, b, x, y, mesh=None):
    lin = torch.nn.Linear(8, 4)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(W))
        lin.bias.copy_(torch.from_numpy(b))
    loss = ((lin(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    if mesh is not None:
        allreduce_grads(lin.parameters(), mesh)
    return lin.weight.grad.numpy(), lin.bias.grad.numpy()


class Head:
    """The first n samples of a dataset."""

    def __init__(self, ds, n):
        self.ds, self.n, self.vocab = ds, n, ds.vocab

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i]


def _batches(cfg, rank, world):
    """Rank `rank`'s first train and graph batches."""
    kw = dict(host_index=rank, host_count=world)
    return (next(Loader(get_dataset("synthetic", "train", cfg), cfg,
                        **kw).epoch(0)),
            next(Loader(get_dataset("synthetic", "train_graph", cfg), cfg,
                        **kw).epoch(0)))


def _val_loader(cfg, rank, world):
    return Loader(Head(get_dataset("synthetic", "val", cfg), VAL_SAMPLES),
                  cfg, shuffle=False, drop_last=False, host_index=rank,
                  host_count=world)


def _val(trainer, loader):
    """The use_gt=False check_model pass (the IoU statistics) with the
    fidelity score."""
    fidelity = FidelityScore(load_backbone(DEFAULT_WEIGHTS)[0],
                             device="cpu")
    return trainer.check_model(loader, False, max_samples=VAL_SAMPLES,
                               fidelity_score=fidelity)[0]


def _named(trainer, attr, *nets):
    """`attr` (a parameter's "grad") of every parameter of `nets` (default
    both) that has one."""
    st = trainer.state
    return {f"{m}.{k}": getattr(p, attr).detach().numpy().copy()
            for m, mod in (("model", st.model), ("disc", st.disc))
            if m in (nets or ("model", "disc"))
            for k, p in mod.named_parameters()
            if getattr(p, attr) is not None}


def _state(trainer):
    """Every tensor of the training state (models and Adams)."""
    st = trainer.state
    out = {f"{m}.{k}": v.detach().numpy().copy()
           for m, mod in (("model", st.model), ("disc", st.disc))
           for k, v in mod.state_dict().items()}
    for name in ckpt_lib.OPTIMIZERS:
        opt = getattr(st, name)
        for i, p in enumerate(p for g in opt.param_groups
                              for p in g["params"]):
            for k, v in opt.state.get(p, {}).items():
                out[f"{name}.{i}.{k}"] = v.numpy().copy()
    return out


def _all_tensors(trainer):
    st = trainer.state
    return [t for obj in (st.model, st.disc, st.opt_graph, st.opt_gen,
                          st.opt_d) for t in state_tensors(obj)]


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def _cli_argv(out):
    argv = []
    for k, v in TINY.items():
        if k == "output_dir":
            continue
        if k == "image_size":
            v = ",".join(map(str, v))
        argv += [f"--{k}", str(int(v) if isinstance(v, bool) else v)]
    return argv + ["--device", "cpu", "--output_dir", out,
                   "--num_iterations", "1", "--checkpoint_every", "1",
                   "--print_every", "1",
                   "--wall_deadline", str(time.time() + 3600)]


def _worker(rank, tmp):
    # One thread each for torch and BLAS: the two ranks and the parent
    # share the CPU, and the fidelity score's sqrtm slows tenfold when
    # their BLAS pools contend.
    torch.set_num_threads(1)
    with threadpool_limits(1):
        _run_rank(rank, tmp)


def _run_rank(rank, tmp):
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
        rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        res = {}
        mesh = make_mesh()
        res["mesh"] = (mesh.rank, mesh.world)
        sl = slice(8 * rank, 8 * rank + 8)

        x, w = _bn_inputs()
        res["bn"] = _bn_run(x[sl], w[sl], mesh)

        W, b, xl, yl = _linear_inputs()
        res["linear"] = _linear_grads(W, b, xl[sl], yl[sl], mesh)

        cfg, vocab = make_cfg(**DP_CFG)
        batch, graph = _batches(cfg, rank, WORLD)
        trainer = Trainer(cfg, vocab, device="cpu", mesh=mesh)
        trainer.init(batch)
        res["init_differ"] = replicas_differ(_all_tensors(trainer), mesh)
        res["val"] = _val(trainer, _val_loader(cfg, rank, WORLD))
        ids = np.arange(rank, VAL_SAMPLES, WORLD, dtype=np.float32)
        res["order"] = gather_in_split_order(np.repeat(ids, 2)[:, None], 2,
                                             mesh, torch.device("cpu"))
        m = trainer.train_step(batch)
        res["grads"] = _named(trainer, "grad")
        m.update(trainer.graph_step(graph))
        res["graph_grads"] = _named(trainer, "grad", "model")
        res["step"] = _metrics(m)
        res["state"] = _state(trainer)
        res["step_differ"] = replicas_differ(_all_tensors(trainer), mesh)

        # One rank's clip carries a NaN frame.
        nan_batch = dict(batch.as_dict(), imgs=batch.imgs.copy())
        if rank == 1:
            nan_batch["imgs"][0, 1] = np.nan
        nan = _metrics(trainer.train_step(nan_batch))
        res["nan"] = dict(skipped=trainer.skipped_nan,
                          loss=nan["G/total_loss"],
                          state=_state(trainer),
                          differ=replicas_differ(_all_tensors(trainer),
                                                 mesh))

        ckpt_lib.SAVE_TIMES.clear()
        out = os.path.join(tmp, "run")
        cli = train_cli.main(_cli_argv(out))
        res["cli"] = dict(saves=[r["path"] for r in ckpt_lib.SAVE_TIMES],
                          step=cli.state.step, mesh=cli.mesh is not None)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results, from one start of two processes, and the
    single-process and flax references, computed here while the ranks run.
    The ranks fork from a server that has imported this module and
    torch._dynamo (which the first optimizer imports) once for both."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    mp.set_forkserver_preload([__name__, "torch._dynamo"])
    ctx = mp.start_processes(_worker, args=(tmp,), nprocs=WORLD, join=False,
                             start_method="forkserver")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        with threadpool_limits(1):
            single = dict(_single(), bn_flax=_bn_flax())
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the two ranks hung"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return dict(ranks=out, tmp=tmp, single=single)


def _bn_flax():
    """flax's nn.BatchNorm in train mode on the whole batch, jitted on one
    device -> (out, mean, var)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    x, _ = _bn_inputs()
    bn = fnn.BatchNorm(use_running_average=False)
    variables = bn.init(jax.random.PRNGKey(0), x)

    @jax.jit
    def fwd(v, x):
        y, upd = bn.apply(v, x, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    y, stats = fwd(variables, jnp.asarray(x))
    return np.asarray(y), np.asarray(stats["mean"]), np.asarray(stats["var"])


def _single():
    """One process over the global batch (rank 0's slice, then rank 1's):
    the validation pass of the fresh trainer, then train_step's gradients
    and, after graph_step, its metrics and state."""
    cfg, vocab = make_cfg(**DP_CFG)
    parts = [_batches(cfg, r, WORLD) for r in range(WORLD)]
    batch, graph = ({k: np.concatenate([p[i].as_dict()[k] for p in parts])
                     for k in parts[0][i].as_dict()} for i in (0, 1))
    trainer = Trainer(cfg, vocab, device="cpu")
    trainer.init(batch)
    out = dict(val=_val(trainer, _val_loader(cfg, 0, 1)))
    m = trainer.train_step(batch)
    out["grads"] = _named(trainer, "grad")
    m.update(trainer.graph_step(graph))
    out.update(graph_grads=_named(trainer, "grad", "model"),
               step=_metrics(m), state=_state(trainer))
    return out


def test_batchnorm_stats_are_global(runs):
    """The port's BatchNorm on two ranks' halves inside a data scope: the
    output and running statistics of flax's nn.BatchNorm on the whole batch
    (jitted on one device), and the output, statistics and input gradient
    of the port's BatchNorm on the whole batch in one process."""
    x, w = _bn_inputs()
    y_flax, mean_flax, var_flax = runs["single"]["bn_flax"]
    want = _bn_run(x, w)
    got = [np.concatenate([r["bn"][i] for r in runs["ranks"]])
           for i in (0, 3)]
    for r in runs["ranks"]:
        assert r["mesh"] == (runs["ranks"].index(r), WORLD)
        np.testing.assert_allclose(r["bn"][1], mean_flax, **STATE_TOL)
        np.testing.assert_allclose(r["bn"][2], var_flax, **STATE_TOL)
        np.testing.assert_allclose(r["bn"][1], want[1], **STATE_TOL)
        np.testing.assert_allclose(r["bn"][2], want[2], **STATE_TOL)
    np.testing.assert_allclose(got[0], y_flax, **OUT_TOL)
    np.testing.assert_allclose(got[0], want[0], **OUT_TOL)
    np.testing.assert_allclose(got[1], want[3], **GRAD_TOL)


def test_gradients_allreduce_equivalence(runs):
    """`allreduce_grads` of a Linear's gradients over two halves == the
    single-process gradient of the global mean loss."""
    want = _linear_grads(*_linear_inputs())
    for r in runs["ranks"]:
        for g, w in zip(r["linear"], want):
            np.testing.assert_allclose(g, w, **GRAD_TOL)


def _rel_l2(got, want, floor):
    return float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), floor)


def test_two_rank_train_step_matches_global_batch(runs):
    """train_step + graph_step on two ranks == one process on the global
    batch: the metrics, the first step's gradients per parameter, the
    parameters after the steps and the BN running statistics; and every
    tensor of the state (models, Adam moments) is bit-equal across the
    ranks, after init and after the steps."""
    r0, r1 = runs["ranks"]
    for r in (r0, r1):
        assert r["init_differ"] == [] and r["step_differ"] == []
        assert set(r["step"]) == set(runs["single"]["step"])
        for k, w in runs["single"]["step"].items():
            assert np.isfinite(r["step"][k])
            assert abs(r["step"][k] - w) <= LOSS_RTOL * max(abs(w), 1.0), \
                (k, r["step"][k], w)
    assert r0["step"] == r1["step"]
    for k, v in r0["state"].items():
        assert np.array_equal(v, r1["state"][k]), k

    # The G and D steps' gradients, then the graph step's (graph_step
    # clears G's first).
    for key, worst, median in (
            ("grads", STEP_GRAD_WORST, STEP_GRAD_MEDIAN),
            ("graph_grads", GRAPH_GRAD_REL, GRAPH_GRAD_REL)):
        errs = _grad_errors(r0[key], runs["single"][key])
        assert errs[-1][0] <= worst, (key, errs[-1])
        assert errs[len(errs) // 2][0] <= median, (key, errs[len(errs) // 2])
    for k, w in runs["single"]["state"].items():
        got = r0["state"][k]
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, w, err_msg=k, **STATE_TOL)
        elif k in r0["grads"]:  # a parameter: a gross change only
            assert np.abs(got - w).max() <= PARAM_ATOL, k


def _grad_errors(grads, want):
    """Sorted (rel-L2, name) of each parameter's gradient against `want`,
    over ZERO_GRAD_REL x its network's largest where its own norm is
    smaller."""
    assert set(grads) == set(want)
    errs = []
    for net in ("model.", "disc."):
        keys = [k for k in want if k.startswith(net)]
        if keys:
            floor = ZERO_GRAD_REL * max(np.linalg.norm(want[k])
                                        for k in keys)
            errs += [(_rel_l2(grads[k], want[k], floor), k) for k in keys]
    return sorted(errs)


def test_nan_skip_is_global(runs):
    """A NaN frame in one rank's clip: both ranks skip the step (the global
    loss is NaN), and every tensor of the state is as it was and equal
    across the ranks."""
    for r in runs["ranks"]:
        nan = r["nan"]
        assert nan["skipped"] == 1 and not np.isfinite(nan["loss"])
        assert nan["differ"] == []
        for k, v in r["state"].items():
            assert np.array_equal(nan["state"][k], v, equal_nan=True), k


def test_check_model_over_unequal_slices(runs):
    """A val split of 5 clips at B=2 over two ranks (3 and 2 clips: 2 and 1
    batches): the IoU statistics and the fidelity score equal one
    process's pass over the split, and nothing hangs. The rows the ranks
    gather come back in the split's order, as the Inception Score's
    splits need them (the scorers' rows go through the same gather)."""
    want = runs["single"]["val"]
    assert {"avg_iou", "total_iou_05", "total_iou_03", "fidelity_fid",
            "fidelity_presence_acc"} <= set(want)
    for r in runs["ranks"]:
        assert r["order"][:, 0].tolist() == np.repeat(
            np.arange(VAL_SAMPLES), 2).tolist()
        assert set(r["val"]) == set(want)
        for k, w in want.items():
            assert np.isclose(r["val"][k], w, rtol=1e-5, atol=1e-6), \
                (k, r["val"][k], w)


def test_fit_writes_on_rank0_only(runs):
    """The training CLI in a two-rank group: both ranks train (over a
    mesh) to the same step; rank 0 alone saves itr_0 and itr_1 and writes
    the metrics stream (one record per step) and run_args.json."""
    r0, r1 = runs["ranks"]
    out = os.path.join(runs["tmp"], "run")
    assert r0["cli"]["mesh"] and r1["cli"]["mesh"]
    assert r0["cli"]["step"] == r1["cli"]["step"] == 1
    assert r1["cli"]["saves"] == []
    assert [os.path.basename(p) for p in r0["cli"]["saves"]] == \
        ["itr_0", "itr_1"]
    for name in ("itr_0", "itr_1"):
        assert ckpt_lib.is_port_checkpoint(os.path.join(out, name))
    assert os.path.isfile(os.path.join(out, "run_args.json"))
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train_steps = [r["step"] for r in records if "G/total_loss" in r]
    assert train_steps == [1]


def test_init_distributed_env(monkeypatch):
    """No launcher variable: a strict no-op. A partial set raises and names
    what is missing. The model axis raises rather than being ignored."""
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is None and not dist.is_initialized()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError,
                       match="LOCAL_RANK, MASTER_ADDR, MASTER_PORT missing"):
        init_distributed(device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(NotImplementedError, match="model axis 2"):
        make_mesh(model=2)
