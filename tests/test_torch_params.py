"""whisper_tpu_torch parameter dicts against whisper_tpu's pytrees."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from whisper_tpu.models.whisper import MODEL_DIMS, WhisperConfig  # noqa: E402
from whisper_tpu.weights.convert import random_params  # noqa: E402
from whisper_tpu_torch.models.whisper import WhisperConfig as TWhisperConfig  # noqa: E402
from whisper_tpu_torch.weights import convert as tconvert  # noqa: E402

TINY = (128, 32, 64, 4, 2, 32, 64, 4, 2, 80)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _torch_dtype_name(t):
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_reproduces_every_leaf(dtype):
    cfg = WhisperConfig(*TINY, "test")
    jp = random_params(cfg, seed=0, dtype=getattr(jnp, dtype))
    jp_np = jax.tree_util.tree_map(np.asarray, jp)
    tp = tconvert.from_jax(jp_np, "cpu")
    fj, ft = _flat(jp_np), _flat(tp)
    assert fj.keys() == ft.keys()
    for name, ref in fj.items():
        got = ft[name]
        assert tuple(got.shape) == ref.shape, name
        assert _torch_dtype_name(got) == ref.dtype.name, name
        if ref.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(), ref.view(np.int16), err_msg=name)
        else:
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)


def test_from_jax_casts_only_matmul_weights():
    cfg = WhisperConfig(*TINY, "test")
    jp_np = jax.tree_util.tree_map(
        np.asarray, random_params(cfg, seed=0, dtype=jnp.float32))
    tp = _flat(tconvert.from_jax(jp_np, "cpu", dtype=torch.bfloat16))
    for name, t in tp.items():
        want = (torch.bfloat16 if name.split("/")[-1] in tconvert.WEIGHT_KEYS
                else torch.float32)
        assert t.dtype == want, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_random_params_shapes_match_large_v3(dtype):
    """Same shapes and dtypes as whisper_tpu's random_params at the exact
    large-v3 dims (JAX side through eval_shape: nothing is allocated)."""
    dims = MODEL_DIMS["large-v3"]
    ref = jax.eval_shape(
        lambda: random_params(WhisperConfig(*dims, "large-v3"), seed=0,
                              dtype=getattr(jnp, dtype)))
    got = tconvert.random_params(TWhisperConfig(*dims, "large-v3"), seed=0,
                                 dtype=getattr(torch, dtype), device="meta")
    fr, fg = _flat(ref), _flat(got)
    assert fr.keys() == fg.keys()
    for name, r in fr.items():
        assert tuple(fg[name].shape) == r.shape, name
        assert _torch_dtype_name(fg[name]) == np.dtype(r.dtype).name, name


def test_random_params_values_and_seed():
    """Layernorm scales are one, rank-1 leaves zero, rank>=2 leaves drawn
    with the stated scale; the seed fixes the draw."""
    cfg = TWhisperConfig(*TINY, "test")
    a = _flat(tconvert.random_params(cfg, seed=3, dtype=torch.float32))
    b = _flat(tconvert.random_params(cfg, seed=3, dtype=torch.float32))
    c = _flat(tconvert.random_params(cfg, seed=4, dtype=torch.float32))
    for name, t in a.items():
        leaf = name.split("/")[-1]
        assert torch.equal(t, b[name]), name
        if leaf.endswith("ln_w") or leaf == "ln_post_w":
            assert torch.all(t == 1), name
        elif t.ndim == 1:
            assert torch.all(t == 0), name
        else:
            assert not torch.equal(t, c[name]), name
            assert 0.015 < float(t.std()) < 0.025, name
