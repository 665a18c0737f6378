#!/usr/bin/env python3
"""Write the JAX package's own outputs for small configurations, so the port
can be held to them on the card, where JAX does not run.

    python3 torch_tools/make_reference_npz.py [generation] [train]
                                              # where JAX runs, on the CPU

With no argument it writes both files.

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
port rebuilds them from the config's seed. The batch is `make_inputs(cfg, vocab,
batch_size, frames_per_action, seed=TRAIN_INPUT_SEED)`. The file holds:

  config                    the Config fields (JSON), param_dtype float32
  <dtype>/losses/<name>     the step's G and D metrics
  <dtype>/model_state/..., <dtype>/d_state/...
                            the norm state after the step (flax_npz.py
                            keys: batch_stats/..., spectral/...)

for <dtype> in float32, bfloat16. chip_smoke.py phase 14 holds the card's
step to it.
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


def train_reference(param_dtype: str):
    """One JAX train_step from the reference trainer's weights -> ({metric:
    float}, flat model_state, flat d_state)."""

    from ag2video_tpu.data.collate import Batch
    from ag2video_tpu.train.state import make_optimizers
    from ag2video_tpu.train.trainer import Trainer as JTrainer
    from ag2video_torch.config import Config as TConfig
    from ag2video_torch.weights import to_flax, transposed_keys
    from chip_smoke import reference_trainer

    vocab = get_vocab("synthetic")
    cfg = Config(param_dtype=param_dtype, **TRAIN_CONFIG).derive(vocab)
    inputs = make_inputs(cfg, vocab, cfg.batch_size, cfg.frames_per_action,
                         seed=TRAIN_INPUT_SEED)
    batch = Batch(video_ids=[], **inputs)
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
    metrics = {k: float(v) for k, v in jt.train_step(batch).items()}
    after = jax.device_get(jt.state)
    return (metrics, flatten_variables(after.model_state),
            flatten_variables(after.d_state))


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
    which = (sys.argv[1:] if argv is None else argv) or ["generation",
                                                         "train"]
    writers = {"generation": write_generation_reference,
               "train": write_train_reference}
    for name in which:
        writers[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
