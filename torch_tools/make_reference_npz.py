#!/usr/bin/env python3
"""Write the JAX package's own outputs for small configurations, so the port
can be held to them on the card, where JAX does not run.

    python3 torch_tools/make_reference_npz.py [generation] [train]
                                              [trajectory]
                                              # where JAX runs, on the CPU

With no argument it writes all three files.

torch_tools/data/reference_factorized_32.npz (`generation`):
The model is the default configuration (factorized frontend) cut to 32x32
and narrow widths (REF_CONFIG), in fp32. Its variables are initialised by
the JAX package, then every leaf that init leaves at a constant (BN
statistics, scales and biases, spectral `u` and `sigma`) gets numpy noise,
and every leaf is rounded to float16 so that the file stays small; the fp32
model then runs on exactly the stored values. The file holds:

  config               the Config fields (JSON; dataset "cater")
  params/..., batch_stats/..., spectral/...   the variables (flax_npz.py)
  input/<key>          the batch (make_inputs, seed 0, B=2)
  output/<key>         imgs_pred, boxes_pred, flows_pred, conf_pred of
                       model.apply(test_mode=True, use_gt=False)

tests/test_torch_factorized.py re-runs the JAX model on the stored file, so
a file that no longer matches the JAX package fails there.

torch_tools/data/reference_train_bf16_64.npz (`train`): one JAX
`Trainer.train_step` on the CPU at tests/test_train.py::tiny_config's
widths at 64x64 with bf16 compute (TRAIN_CONFIG), once with fp32 params
and once with `param_dtype="bfloat16"`. The weights are the port's own
numpy-drawn ones (`chip_smoke.reference_trainer`: the same on every
machine, where torch's seeded init may differ between torch versions),
carried into the JAX TrainState by `weights.to_flax` and bf16-cast by the
JAX package's own rule for bf16 params, so the file stores no weights: the
port rebuilds them from the config's seed. The batch is `make_inputs(cfg,
vocab, batch_size, frames_per_action, seed=TRAIN_INPUT_SEED)`. The file
holds:

  config                    the Config fields (JSON), param_dtype float32
  <dtype>/losses/<name>     the step's G and D metrics
  <dtype>/model_state/..., <dtype>/d_state/...
                            the norm state after the step (flax_npz.py
                            keys: batch_stats/..., spectral/...)

for <dtype> in float32, bfloat16. chip_smoke.py phase 14 holds the card's
step to it.

torch_tools/data/reference_trajectory_64.npz (`trajectory`): 8 JAX
training iterations on the CPU, each a `Trainer.train_step` then a
`graph_step`, at the `train` file's configuration with fp32 params, lr
1e-5 and an LR schedule that decays over the second half with TTUR's
split (TRAJECTORY_CONFIG: niter=4, niter_decay=4, no_TTUR=False: G's
decayed rate halved, D's doubled), once per compute dtype (float32,
bfloat16), from the same carried weights. Iteration k takes
`make_inputs(cfg, vocab, batch_size, frames_per_action,
seed=train_seeds[k])` and a graph batch of 4 * frames_per_action_graph
frames from graph_seeds[k]. The same 8 iterations are then rerun twice
with the rounding perturbed: every batch's float inputs (imgs, boxes, and
the real-valued columns 3: of actions; the ids in columns 0-2 stay) scaled
by 1 + eps and every initial parameter element by 1 + eps * z, z ~ N(0, 1)
drawn from RandomState(run) for runs 1-4, eps = perturbation[<dtype>]
(1e-6 for float32, 2^-8 for bfloat16). Each quantity's largest difference
between a perturbed run and the first is the reference's own spread, what
rounding alone moves it by: a uniform input scale alone is normalised
away by the BatchNorms, the weights' noise is not. The file holds:

  config, train_seeds, graph_seeds, perturbation/<dtype>
  <dtype>/metrics/<name>    (K,) every metric of train_step and graph_step
  <dtype>/lr/<G|D|Graph>    (K,) the learning rate of each iteration's
                            update (the optax schedule at its count)
  <dtype>/model_state/..., <dtype>/d_state/...
                            the norm state after iteration K (flax_npz.py
                            keys: batch_stats/..., spectral/...)
  <dtype>/update/<model|disc>/<port key>
                            per parameter, update = final - initial in the
                            port's layout (weights.flax_to_state_dict): the
                            float64 [L2 norm, projection on r1, projection
                            on r2], r_j the seeded N(0, 1) vectors of
                            torch_tools/trajectory.py's `projections` (the
                            updates themselves take 14 MB per dtype in
                            float16)
  <dtype>/sigma_true/<G|D>/<kernel path>
                            tools/sigma_audit.py's exact top singular value
                            of each spectrally normalised kernel after
                            iteration K (its stored sigma is in d_state /
                            model_state)
  spread/<dtype>/...        the same keys: for metrics |perturbed run -
                            run| per iteration, for each norm-state leaf
                            and each update the L2 norm of the difference,
                            for sigma_true the absolute difference, and
                            spread/<dtype>/update_total/<model|disc> over
                            each network's whole update; the largest over
                            the perturbed runs
  spread/<dtype>/update_norm/<model|disc>
                            |difference of the L2 norms| of each network's
                            whole update, the largest over the runs

torch_tools/trajectory.py holds the port to it (tests/test_torch_
trajectory.py on the CPU, chip_smoke.py phase 18 on the card).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ag2video_tpu.config import Config  # noqa: E402
from ag2video_tpu.models.meta import AG2VideoModel  # noqa: E402
from ag2video_tpu.vocab import get_vocab  # noqa: E402
from ag2video_torch.flax_npz import flatten_variables  # noqa: E402
from ag2video_torch.inference import make_inputs  # noqa: E402

PATH = os.path.join(ROOT, "torch_tools", "data",
                    "reference_factorized_32.npz")
TRAIN_PATH = os.path.join(ROOT, "torch_tools", "data",
                          "reference_train_bf16_64.npz")
# tests/test_train.py::tiny_config at 64x64, bf16 compute.
TRAIN_CONFIG = dict(dataset="synthetic", image_size=(64, 64), batch_size=2,
                    frames_per_action=2, frames_per_action_graph=1,
                    embedding_dim=16, gconv_dim=16, gconv_hidden_dim=32,
                    gconv_num_layers=2, ngf=4, nff=4, n_blocks_F=1,
                    n_downsample_F=2, num_D=2, n_layers_D=2, dataset_size=16,
                    number_of_objects=3, max_objects=5, max_triplets=6,
                    max_actions=2, learning_rate=1e-3,
                    compute_dtype="bfloat16", no_vgg_loss=True,
                    output_dir="")
TRAIN_INPUT_SEED = 0
PARAM_DTYPES = ("float32", "bfloat16")
TRAJECTORY_PATH = os.path.join(ROOT, "torch_tools", "data",
                               "reference_trajectory_64.npz")
# The LR schedule decays over the second half, with TTUR's split (G's
# decayed rate halved, D's doubled), at the fp32 training tests' rate:
# at 1e-3 Adam's +-lr steps on rounding-level gradient elements make the
# 8 iterations chaotic (two summation orders differ by 1e-2 in the
# losses), and no per-quantity bound holds.
TRAJECTORY_CONFIG = dict(TRAIN_CONFIG, niter=4, niter_decay=4,
                         no_TTUR=False, learning_rate=1e-5)
TRAJECTORY_ITERATIONS = 8
TRAJECTORY_GRAPH_SEED = 100
COMPUTE_DTYPES = ("float32", "bfloat16")
PERTURBATION = {"float32": 1e-6, "bfloat16": 2.0 ** -8}
PERTURBED_RUNS = (1, 2, 3, 4)   # the seeds of the weights' noise
REF_CONFIG = dict(dataset="cater", image_size=(32, 32), frames_per_action=3,
                  max_objects=5, max_triplets=6, max_actions=2,
                  embedding_dim=4, gconv_dim=8, gconv_hidden_dim=16,
                  gconv_num_layers=2, ngf=1, nff=4, n_blocks_F=1,
                  n_downsample_F=2, generator_cond_nc=8,
                  compute_dtype="float32")
INPUTS = ("imgs", "objs", "triplets", "actions", "boxes")
OUTPUTS = ("imgs_pred", "boxes_pred", "flows_pred", "conf_pred")


def perturb(variables, rng: np.random.RandomState):
    """Noise on every leaf that init leaves at a constant, then rounding of
    every leaf to a float16 value."""
    out = {}
    for col, tree in variables.items():
        def f(path, a):
            a = np.asarray(a, np.float32)
            name = str(path[-1].key)
            if col == "batch_stats" and name == "var":
                a = a * np.asarray(rng.uniform(0.5, 1.5, a.shape), np.float32)
            elif col in ("batch_stats", "spectral") or \
                    name in ("bias", "scale"):
                scale = 0.5 if col == "spectral" else 0.1
                a = a + np.asarray(scale * rng.randn(*a.shape), np.float32)
            return a.astype(np.float16).astype(np.float32)
        out[col] = jax.tree_util.tree_map_with_path(f, tree)
    return out


def model_and_config():
    vocab = get_vocab("cater")
    cfg = Config(**REF_CONFIG).derive(vocab)
    return AG2VideoModel(config=cfg, vocab=vocab), cfg, vocab


def with_stored(variables_like, flat):
    """`variables_like`'s flax structure with each leaf read from the flat
    `<collection>/<path>` arrays."""
    def f(col):
        return lambda path, _: jnp.asarray(flat["/".join(
            (col,) + tuple(str(p.key) for p in path))], jnp.float32)
    return {col: jax.tree_util.tree_map_with_path(f(col), tree)
            for col, tree in variables_like.items()}


def apply(model, variables, inputs):
    args = tuple(jnp.asarray(inputs[k]) for k in INPUTS)
    out = jax.jit(lambda v: model.apply(v, *args, test_mode=True,
                                        use_gt=False, train=False))(variables)
    return {k: np.asarray(out[k], np.float32) for k in OUTPUTS}


def carried_trainer(cfg, vocab, batch):
    """A JAX Trainer initialised on `batch` whose weights are the port's
    reference trainer's (`chip_smoke.reference_trainer`), carried in by
    `weights.to_flax`, with fresh optimizers -> (JAX trainer, port
    trainer)."""
    from ag2video_tpu.train.state import make_optimizers
    from ag2video_tpu.train.trainer import Trainer as JTrainer
    from ag2video_torch.config import Config as TConfig
    from ag2video_torch.weights import to_flax, transposed_keys
    from chip_smoke import reference_trainer

    jt = JTrainer(cfg, vocab)
    jt.init(batch)
    st = jax.device_get(jt.state)
    port = reference_trainer(TConfig.from_dict(cfg.to_dict()), vocab, "cpu")

    def carried(template, module):
        return to_flax(template, module.state_dict(), transposed_keys(module))

    m = carried({"params": st.params, **st.model_state}, port.state.model)
    d = carried({"params": st.d_params, **st.d_state}, port.state.disc)
    cast = lambda t, like: jax.tree.map(
        lambda a, b: jnp.asarray(a, jnp.asarray(b).dtype), t, like)
    params, d_params = cast(m.pop("params"), st.params), \
        cast(d.pop("params"), st.d_params)
    og, oe, od = make_optimizers(cfg, params)
    jt.state = jt.state.replace(
        params=params, model_state=m, d_params=d_params, d_state=d,
        opt_graph_state=og.init(params), opt_gen_state=oe.init(params),
        opt_d_state=od.init(d_params))
    return jt, port


def train_reference(param_dtype: str):
    """One JAX train_step from the reference trainer's weights -> ({metric:
    float}, flat model_state, flat d_state)."""

    from ag2video_tpu.data.collate import Batch

    vocab = get_vocab("synthetic")
    cfg = Config(param_dtype=param_dtype, **TRAIN_CONFIG).derive(vocab)
    inputs = make_inputs(cfg, vocab, cfg.batch_size, cfg.frames_per_action,
                         seed=TRAIN_INPUT_SEED)
    batch = Batch(video_ids=[], **inputs)
    jt, _ = carried_trainer(cfg, vocab, batch)
    metrics = {k: float(v) for k, v in jt.train_step(batch).items()}
    after = jax.device_get(jt.state)
    return (metrics, flatten_variables(after.model_state),
            flatten_variables(after.d_state))


def _count(opt_state) -> int:
    """The update count of an optax state (every `count` leaf in it)."""
    counts = {int(v) for p, v in
              jax.tree_util.tree_flatten_with_path(opt_state)[0]
              if str(getattr(p[-1], "name", "")) == "count"}
    if len(counts) != 1:
        raise ValueError(f"optax counts {counts}")
    return counts.pop()


def trajectory_run(jt, state0, cfg, vocab, eps: float = 0.0, seed: int = 0):
    """TRAJECTORY_ITERATIONS iterations of `jt` from `state0` (host
    arrays), the float inputs scaled by 1 + eps and each initial parameter
    element by 1 + eps * z (z ~ N(0, 1) from RandomState(seed)) ->
    (metrics {name: (K,)}, lrs {G/D/Graph: (K,)}, initial state, final
    state, both on the host)."""
    from ag2video_tpu.data.collate import Batch
    from ag2video_tpu.train.state import _lr_schedule

    if eps:
        rng = np.random.RandomState(seed)
        scale = lambda a: np.asarray(a * (1 + eps * rng.standard_normal(
            np.shape(a))).astype(np.float32), np.asarray(a).dtype)
        state0 = state0.replace(
            params=jax.tree.map(scale, state0.params),
            d_params=jax.tree.map(scale, state0.d_params))
    ttur = not cfg.no_TTUR   # the scales of make_optimizers
    sched = {"G": (0.5 if ttur else 1.0, "opt_gen_state"),
             "D": (2.0 if ttur else 1.0, "opt_d_state"),
             "Graph": (1.0, "opt_graph_state")}
    jt.state = jax.device_put(state0)
    metrics, lrs = {}, {k: [] for k in sched}
    B, fpa = cfg.batch_size, cfg.frames_per_action
    for k in range(TRAJECTORY_ITERATIONS):
        batch = make_inputs(cfg, vocab, B, fpa, seed=TRAIN_INPUT_SEED + k)
        graph = make_inputs(cfg, vocab, B, 4 * cfg.frames_per_action_graph,
                            seed=TRAJECTORY_GRAPH_SEED + k)
        for b in (batch, graph):
            b["imgs"] = b["imgs"] * np.float32(1 + eps)
            b["boxes"] = b["boxes"] * np.float32(1 + eps)
            b["actions"][..., 3:] *= np.float32(1 + eps)
        for name, (scale, field) in sched.items():
            lr = _lr_schedule(cfg, scale)
            count = _count(getattr(jt.state, field))
            lrs[name].append(float(lr(count) if callable(lr) else lr))
        m = dict(jt.train_step(Batch(video_ids=[], **batch)))
        m.update(jt.graph_step(Batch(video_ids=[], **graph)))
        for name, v in m.items():
            metrics.setdefault(name, []).append(float(v))
    return ({k: np.asarray(v, np.float32) for k, v in metrics.items()},
            {k: np.asarray(v, np.float64) for k, v in lrs.items()},
            state0, jax.device_get(jt.state))


def trajectory_reference(compute_dtype: str):
    """The trajectory file's arrays for one compute dtype (keys without the
    `<dtype>/` prefix, spreads under `spread/`)."""
    from ag2video_tpu.data.collate import Batch
    from ag2video_torch.weights import flax_to_state_dict, transposed_keys
    from tools.sigma_audit import audit_tree
    from torch_tools.trajectory import projections

    vocab = get_vocab("synthetic")
    cfg = Config(**dict(TRAJECTORY_CONFIG, compute_dtype=compute_dtype)
                 ).derive(vocab)
    first = make_inputs(cfg, vocab, cfg.batch_size, cfg.frames_per_action,
                        seed=TRAIN_INPUT_SEED)
    jt, port = carried_trainer(cfg, vocab, Batch(video_ids=[], **first))
    state0 = jax.device_get(jt.state)
    nets = {"model": (port.state.model, "params", "model_state", "G"),
            "disc": (port.state.disc, "d_params", "d_state", "D")}

    def quantities(before, after):
        """{key: array} of one run's end: norm state, updates, sigma_true."""
        out = {}
        for net, (module, pfield, sfield, tag) in nets.items():
            out.update({f"{sfield}/{k}": v for k, v in flatten_variables(
                getattr(after, sfield)).items()})
            initial, final = (flax_to_state_dict(
                {"params": getattr(s, pfield)}, transposed_keys(module))
                for s in (before, after))
            for k, _ in module.named_parameters():
                out[f"update/{net}/{k}"] = (final[k] - initial[k]).numpy()
            spectral = getattr(after, sfield).get("spectral", {})
            for path, _, true in audit_tree(getattr(after, pfield), spectral,
                                            tag):
                out[f"sigma_true/{tag}/{path}"] = np.float64(true)
        return out

    eps = PERTURBATION[compute_dtype]
    m0, lr0, before, after = trajectory_run(jt, state0, cfg, vocab)
    q0 = quantities(before, after)
    arrays = {f"metrics/{k}": v for k, v in m0.items()}
    arrays.update({f"lr/{k}": v for k, v in lr0.items()})
    for k, v in q0.items():
        arrays[k] = projections(k[len("update/"):], v) \
            if k.startswith("update/") else v
    norm = lambda a: float(np.linalg.norm(np.asarray(a, np.float64).ravel()))
    spread = {}
    for seed in PERTURBED_RUNS:
        m1, _, before, after = trajectory_run(jt, state0, cfg, vocab, eps,
                                              seed)
        q1 = quantities(before, after)
        found = {f"metrics/{k}": np.abs(m1[k] - v) for k, v in m0.items()}
        totals = {}
        for k, v in q0.items():
            found[k] = norm(q1[k] - v)
            if k.startswith("update/"):
                t = totals.setdefault(k.split("/")[1], [0.0, 0.0, 0.0])
                t[0] += found[k] ** 2
                t[1] += norm(q1[k]) ** 2
                t[2] += norm(v) ** 2
        for net, (d, n1, n0) in totals.items():
            found[f"update_total/{net}"] = d ** 0.5
            found[f"update_norm/{net}"] = abs(n1 ** 0.5 - n0 ** 0.5)
        for k, v in found.items():
            spread[k] = np.maximum(spread.get(k, 0.0), v)
    arrays.update({f"spread/{k}": (v.astype(np.float32) if k.startswith(
        "metrics/") else np.float64(v)) for k, v in spread.items()})
    # the schedule decays over the second half
    assert lr0["G"][-1] < lr0["G"][0] and lr0["D"][-1] > lr0["G"][-1], lr0
    print(f"{compute_dtype} compute: " + ", ".join(
        f"{k} {v[0]:.4f}->{v[-1]:.4f}" for k, v in sorted(m0.items())))
    return arrays


def write_trajectory_reference() -> None:
    vocab = get_vocab("synthetic")
    cfg = Config(**TRAJECTORY_CONFIG).derive(vocab)
    K = TRAJECTORY_ITERATIONS
    arrays = {"config": np.array(json.dumps(cfg.to_dict())),
              "train_seeds": TRAIN_INPUT_SEED + np.arange(K),
              "graph_seeds": TRAJECTORY_GRAPH_SEED + np.arange(K)}
    for dtype in COMPUTE_DTYPES:
        arrays[f"perturbation/{dtype}"] = np.float64(PERTURBATION[dtype])
        for k, v in trajectory_reference(dtype).items():
            if k.startswith("spread/"):
                arrays[f"spread/{dtype}/{k[len('spread/'):]}"] = v
            else:
                arrays[f"{dtype}/{k}"] = v
    os.makedirs(os.path.dirname(TRAJECTORY_PATH), exist_ok=True)
    np.savez_compressed(TRAJECTORY_PATH, **arrays)
    print(f"{TRAJECTORY_PATH}: {os.path.getsize(TRAJECTORY_PATH)} bytes, "
          f"{len(arrays)} arrays")


def write_train_reference() -> None:
    vocab = get_vocab("synthetic")
    cfg = Config(**TRAIN_CONFIG).derive(vocab)
    arrays = {"config": np.array(json.dumps(cfg.to_dict()))}
    for dtype in PARAM_DTYPES:
        metrics, m_state, d_state = train_reference(dtype)
        arrays.update({f"{dtype}/losses/{k}": np.float32(v)
                       for k, v in metrics.items()})
        arrays.update({f"{dtype}/model_state/{k}": v
                       for k, v in m_state.items()})
        arrays.update({f"{dtype}/d_state/{k}": v for k, v in d_state.items()})
        print(f"{dtype} params: " + ", ".join(
            f"{k} {v:.6f}" for k, v in sorted(metrics.items())))
    os.makedirs(os.path.dirname(TRAIN_PATH), exist_ok=True)
    np.savez_compressed(TRAIN_PATH, **arrays)
    print(f"{TRAIN_PATH}: {os.path.getsize(TRAIN_PATH)} bytes")


def write_generation_reference() -> None:
    model, cfg, vocab = model_and_config()
    inputs = make_inputs(cfg, vocab, 2, cfg.frames_per_action, seed=0)
    args = tuple(jnp.asarray(inputs[k]) for k in INPUTS)
    variables = jax.jit(lambda k: model.init(
        {"params": k}, *args, use_gt=True, train=False))(
            jax.random.PRNGKey(0))
    variables = perturb(variables, np.random.RandomState(1))
    outputs = apply(model, variables, inputs)
    arrays = {k: v.astype(np.float16)
              for k, v in flatten_variables(variables).items()}
    arrays["config"] = np.array(json.dumps(cfg.to_dict()))
    arrays.update({f"input/{k}": np.asarray(v) for k, v in inputs.items()})
    arrays.update({f"output/{k}": v for k, v in outputs.items()})
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **arrays)
    print(f"{PATH}: {os.path.getsize(PATH)} bytes, "
          f"{sum(k.split('/')[0] in ('params', 'batch_stats', 'spectral') for k in arrays)} "
          f"variables")


def main(argv=None) -> int:
    which = (sys.argv[1:] if argv is None else argv) or [
        "generation", "train", "trajectory"]
    writers = {"generation": write_generation_reference,
               "train": write_train_reference,
               "trajectory": write_trajectory_reference}
    for name in which:
        writers[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
