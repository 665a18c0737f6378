#!/usr/bin/env python3
"""Write torch_tools/data/reference_factorized_32.npz: the JAX package's own
outputs for a small default-config model, so the port can be held to them
on the card, where JAX does not run.

    python3 torch_tools/make_reference_npz.py     # where JAX runs, on the CPU

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


def main() -> int:
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
