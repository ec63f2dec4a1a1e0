"""The encoder's attention variants and layouts against whisper_tpu's, on
the same weights and inputs (CPU; kernels run as their plain versions, the
JAX side's Pallas kernels in interpret mode): `encode` for every
`attn_impl`, K1's (B, H, Dh, Tp) entry and K6 with keys masked past
t_valid, and the channels-first hand-off encode(out_layout="bdt") ->
cross_kv*(enc_layout="bdt")."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from whisper_tpu.models import whisper as wm  # noqa: E402
from whisper_tpu.ops import encoder_attention as jea  # noqa: E402
from whisper_tpu.weights.convert import random_params  # noqa: E402
from whisper_tpu_torch.models import whisper as tm  # noqa: E402
from whisper_tpu_torch.ops import encoder_attention as tea  # noqa: E402
from whisper_tpu_torch.weights.convert import from_jax  # noqa: E402

# n_audio_ctx 32: not a multiple of the 256 the padded variants pad to
TINY = (128, 32, 64, 4, 2, 32, 64, 4, 2, 80)
# float32: rounding order only; bfloat16: the frameworks round matmul
# results and operands to bf16 at different points (the Pallas bound)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
IMPLS = ["einsum", "pallas", "pallas_interpret", "flash", "pallas_dt",
         "pallas_dt_interpret", "pallas_pf", "pallas_pf_interpret",
         "pallas_btd", "pallas_btd_interpret"]


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    dtype = request.param
    cfg = wm.WhisperConfig(*TINY, "test")
    jp = random_params(cfg, seed=0, dtype=getattr(jnp, dtype))
    return {"dtype": dtype, "jcd": getattr(jnp, dtype),
            "tcd": getattr(torch, dtype), "tol": TOL[dtype], "jp": jp,
            "tp": from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu"),
            "mel": np.random.RandomState(11).randn(2, 64, 80).astype(
                np.float32)}


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_jax(model, impl):
    """Each impl against the same impl of whisper_tpu.  "flash" runs JAX's
    stock Pallas flash kernel in interpret mode, which works on the CPU."""
    m = model
    with pltpu.force_tpu_interpret_mode():
        ref = wm.encode(m["jp"], jnp.asarray(m["mel"]), n_head=4,
                        compute_dtype=m["jcd"], attn_impl=impl)
    got = tm.encode(m["tp"], _t(m["mel"]), n_head=4, compute_dtype=m["tcd"],
                    attn_impl=impl)
    assert got.dtype == torch.float32
    assert _rel_err(got.numpy(), ref) <= m["tol"]


def test_encode_bdt_to_cross_kv(model):
    """encode(out_layout="bdt") and cross_kv / cross_kv_q8 reading it with
    enc_layout="bdt", against whisper_tpu's (the q8 scales, and the codes
    dequantized, to the dense bound: a one-ulp difference in a column's
    largest element moves all of its codes, see test_torch_model.py)."""
    m = model
    with pltpu.force_tpu_interpret_mode():
        jenc = wm.encode(m["jp"], jnp.asarray(m["mel"]), n_head=4,
                         compute_dtype=m["jcd"], attn_impl="pallas_dt",
                         out_layout="bdt")
    tenc = tm.encode(m["tp"], _t(m["mel"]), n_head=4, compute_dtype=m["tcd"],
                     attn_impl="pallas_dt", out_layout="bdt")
    assert tuple(tenc.shape) == (2, 64, 32) == jenc.shape
    assert _rel_err(tenc.numpy(), jenc) <= m["tol"]
    tenc_btd = tm.encode(m["tp"], _t(m["mel"]), n_head=4,
                         compute_dtype=m["tcd"], attn_impl="pallas_dt")
    np.testing.assert_array_equal(tenc.transpose(1, 2).numpy(),
                                  tenc_btd.numpy())

    cd = dict(n_head=4, enc_layout="bdt")
    jkc, jvc = wm.cross_kv(m["jp"], jenc, compute_dtype=m["jcd"], **cd)
    tkc, tvc = tm.cross_kv(m["tp"], tenc, compute_dtype=m["tcd"], **cd)
    for g, r in ((tkc, jkc), (tvc, jvc)):
        assert g.dtype == m["tcd"]
        assert _rel_err(g.float().numpy(), r) <= m["tol"]
    (jkq, jks), (jvq, jvs) = wm.cross_kv_q8(m["jp"], jenc,
                                            compute_dtype=m["jcd"], **cd)
    (tkq, tks), (tvq, tvs) = tm.cross_kv_q8(m["tp"], tenc,
                                            compute_dtype=m["tcd"], **cd)
    for tq, ts, jq, js in ((tkq, tks, jkq, jks), (tvq, tvs, jvq, jvs)):
        assert tq.dtype == torch.int8 and tuple(tq.shape) == jq.shape
        assert _rel_err(ts.numpy(), js) <= m["tol"]
        deq = np.asarray(jq, np.float32) * np.asarray(js)[..., None, :]
        assert _rel_err(tq.float().numpy() * ts.numpy()[..., None, :],
                        deq) <= max(m["tol"], 1.0 / 127)


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) * 0.3 for _ in range(3)]


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-5)])
def test_k1_bhdt_entry_matches_pallas(dtype, tol):
    """K1's (B, H, Dh, Tp) entry: keys at or past t_valid = 200 of Tp = 256
    masked, every row computed (the padded rows included)."""
    q, k, v = _qkv((2, 3, 64, 256), 5)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jea.encoder_attention(*(jnp.asarray(x).astype(jd)
                                  for x in (q, k, v)), t_valid=200,
                                interpret=True)
    got = tea.encoder_attention(*(_t(x).to(td) for x in (q, k, v)),
                                t_valid=200)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, 64, 256)
    assert _rel_err(got.numpy(), ref) <= tol


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-5)])
@pytest.mark.parametrize("n_head", [2, 3])
def test_k6_btd_matches_pallas(dtype, tol, n_head):
    """K6 on (B, Tp, D) with t_valid = 200 of Tp = 256; three heads do not
    fill the TPU kernel's 128-lane head groups (it falls back to one head
    per group), which the port does not have."""
    q, k, v = _qkv((2, 256, 64 * n_head), 6)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jea.encoder_attention_btd(*(jnp.asarray(x).astype(jd)
                                      for x in (q, k, v)), n_head=n_head,
                                    t_valid=200, interpret=True)
    got = tea.encoder_attention_btd(*(_t(x).to(td) for x in (q, k, v)),
                                    n_head=n_head, t_valid=200)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    assert _rel_err(got.numpy(), ref) <= tol


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-5)])
@pytest.mark.parametrize("t_valid", [1, 63, 64, 65, 255, 256])
@pytest.mark.parametrize("entry", ["bhdt", "btd"])
def test_padded_plain_versions_mask_pad_keys(entry, t_valid, dtype, tol):
    """The plain versions that the card holds K1's (B, H, Dh, Tp) entry and
    K6 against, against the Pallas kernels in interpret mode at Tp = 256:
    one valid key, t_valid around a 64-key edge, one key short and none
    padded.  The pad keys and values are 1e4, so only a mask by index (not
    by the data) keeps them out."""
    shape = (1, 2, 64, 256) if entry == "bhdt" else (1, 256, 128)
    q, k, v = _qkv(shape, 7)
    for x in (k, v):
        if entry == "bhdt":
            x[..., t_valid:] = 1e4
        else:
            x[:, t_valid:] = 1e4
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    tq, tk, tv = (_t(x).to(td) for x in (q, k, v))
    if entry == "bhdt":
        ref = jea.encoder_attention(jq, jk, jv, t_valid=t_valid,
                                    interpret=True)
        got = tea.encoder_attention_ref(tq, tk, tv, t_valid)
    else:
        ref = jea.encoder_attention_btd(jq, jk, jv, n_head=2,
                                        t_valid=t_valid, interpret=True)
        got = tea.encoder_attention_btd_ref(tq, tk, tv, 2, t_valid)
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    assert _rel_err(got.numpy(), ref) <= tol


def test_wrappers_route_and_refuse():
    """CPU tensors run the plain versions and launch nothing; another device
    or a t_valid outside [1, Tp] is refused."""
    n1, n6 = tea.encoder_attention.launches, tea.encoder_attention_btd.launches
    x = torch.zeros(1, 2, 64, 16)
    tea.encoder_attention(x, x, x, t_valid=9)
    y = torch.zeros(1, 16, 128)
    tea.encoder_attention_btd(y, y, y, n_head=2, t_valid=9)
    assert (tea.encoder_attention.launches,
            tea.encoder_attention_btd.launches) == (n1, n6)
    for bad in (0, 17):
        with pytest.raises(ValueError):
            tea.encoder_attention(x, x, x, t_valid=bad)
        with pytest.raises(ValueError):
            tea.encoder_attention_btd(y, y, y, n_head=2, t_valid=bad)
    meta = x.to("meta")
    with pytest.raises(ValueError):
        tea.encoder_attention(meta, meta, meta)
    with pytest.raises(ValueError):
        tea.encoder_attention_btd(y.to("meta"), y.to("meta"), y.to("meta"),
                                  n_head=2)


def test_default_impl_and_layout_checks():
    """The default impl follows the tensors' device ("einsum" on the CPU, as
    whisper_tpu's on its CPU backend); out_layout="bdt" needs pallas_dt."""
    assert tm.default_encoder_attn_impl(torch.zeros(1)) == "einsum"
    cfg = wm.WhisperConfig(*TINY, "test")
    tp = from_jax(jax.tree_util.tree_map(
        np.asarray, random_params(cfg, seed=0, dtype=jnp.float32)), "cpu")
    mel = _t(np.random.RandomState(1).randn(1, 64, 80))
    got = tm.encode(tp, mel, n_head=4, compute_dtype=torch.float32)
    want = tm.encode(tp, mel, n_head=4, compute_dtype=torch.float32,
                     attn_impl="einsum")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for impl in ("pallas", "pallas_pf", "pallas_btd", "einsum"):
        with pytest.raises(ValueError, match="pallas_dt"):
            tm.encode(tp, mel, n_head=4, compute_dtype=torch.float32,
                      attn_impl=impl, out_layout="bdt")
    with pytest.raises(ValueError, match="attn_impl"):
        tm.encode(tp, mel, n_head=4, attn_impl="pallas_xyz")
