"""whisper_tpu_torch's ggml reader, writer, block codecs and
params_from_ggml against whisper_tpu's, on random-weight files written here
(f32, f16 and the five block-quantized types): hparams, vocab, filters and
every parameter leaf bit for bit."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from whisper_tpu.audio.filters import mel_filterbank  # noqa: E402
from whisper_tpu.ops import quantized as jq  # noqa: E402
from whisper_tpu.weights import convert as jconvert  # noqa: E402
from whisper_tpu.weights import quant as jquant  # noqa: E402
from whisper_tpu.weights.ggml_reader import read_ggml_file as jread  # noqa: E402
from whisper_tpu.weights.ggml_reader import synthetic_vocab  # noqa: E402
from whisper_tpu.weights.ggml_writer import write_ggml  # noqa: E402
from whisper_tpu_torch.ops import quantized as tq  # noqa: E402
from whisper_tpu_torch.weights import convert as tconvert  # noqa: E402
from whisper_tpu_torch.weights import ggml_writer as twriter  # noqa: E402
from whisper_tpu_torch.weights import quant as tquant  # noqa: E402
from whisper_tpu_torch.weights.ggml_reader import read_ggml_file as tread  # noqa: E402

# widths are multiples of 128, so whisper_tpu keeps the decoder packed;
# 51865 is multilingual (language detection runs); 3 decoder layers, since
# 2 would mark the model as a first-release distilled one (no timestamps)
MICRO = (51865, 32, 128, 4, 2, 48, 128, 4, 3, 80)


def model_tensors(dims, seed=0, std=0.05):
    """Random tensors of a Whisper model at `dims`, by ggml tensor name
    (layernorm scales around one)."""
    hp = dict(zip(twriter.HPARAM_KEYS, dims))
    rng = np.random.RandomState(seed)
    tensors = {}
    for name, shape in twriter.model_tensor_shapes(hp):
        x = (rng.randn(*shape) * std).astype(np.float32)
        tensors[name] = x + 1.0 if name.endswith(("ln.weight",
                                                  "ln_post.weight")) else x
    return hp, tensors


def write_model(path, kind="q5_0", dims=MICRO, seed=0, writer=write_ggml):
    """A random-weight ggml file of `kind` (a FILE_TYPES key), written by
    `writer` (whisper_tpu's write_ggml by default), with a synthetic vocab
    and the real mel filterbank.  Returns the path as a string."""
    hp, tensors = model_tensors(dims, seed)
    ftype, qtype = twriter.FILE_TYPES[kind]
    tokens = synthetic_vocab(hp["n_vocab"]).id_to_token[:50257]
    writer(str(path), hp, mel_filterbank(hp["n_mels"]).astype(np.float32),
           tokens, tensors, ftype=ftype, qtype=qtype)
    return str(path)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _assert_same_leaf(got: torch.Tensor, ref: np.ndarray, name: str):
    assert tuple(got.shape) == ref.shape, name
    assert str(got.dtype).removeprefix("torch.") == ref.dtype.name, name
    if ref.dtype.name == "bfloat16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      ref.view(np.int16), err_msg=name)
    else:
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)


FILE_TYPES = twriter.FILE_TYPES
QTYPES = [t for _, t in FILE_TYPES.values() if t is not None]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ggml")
    return {kind: write_model(d / f"{kind}.bin", kind) for kind in FILE_TYPES}


@pytest.mark.parametrize("kind", list(FILE_TYPES))
def test_reader_matches_jax(files, kind):
    ref, got = jread(files[kind]), tread(files[kind])
    assert got.hparams.__dict__ == ref.hparams.__dict__
    assert got.hparams.model_type == ref.hparams.model_type
    assert got.wtype == ref.wtype and got.n_loaded == ref.n_loaded
    np.testing.assert_array_equal(got.filters, ref.filters)
    assert got.vocab.__dict__ == ref.vocab.__dict__
    assert got.tensors.keys() == ref.tensors.keys()
    for name, rt in ref.tensors.items():
        gt = got.tensors[name]
        assert (gt.ttype, gt.ne, gt.data) == (rt.ttype, rt.ne, rt.data), name
        np.testing.assert_array_equal(gt.to_numpy(), rt.to_numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("kind", list(FILE_TYPES))
def test_writer_bytes_match_jax(files, kind, tmp_path):
    """The port's writer produces the same bytes as whisper_tpu's."""
    path = write_model(tmp_path / "port.bin", kind, writer=twriter.write_ggml)
    with open(path, "rb") as a, open(files[kind], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("qtype", QTYPES)
def test_codecs_and_unpack_bit_exact(qtype):
    rng = np.random.RandomState(qtype)
    w = (rng.randn(256, 128) * 0.1 + 0.01).astype(np.float32)
    raw = tquant.QUANTIZERS[qtype](w)
    assert raw == jquant.QUANTIZERS[qtype](w)
    assert tquant.type_nbytes(qtype, w.size) == len(raw)
    np.testing.assert_array_equal(tquant.decode_tensor(raw, qtype, w.shape),
                                  jquant.decode_tensor(raw, qtype, w.shape))
    got = tq.unpack_to_codes(raw, qtype, w.shape)
    ref = jq.unpack_to_codes(raw, qtype, w.shape)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None:
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(FILE_TYPES))
def test_params_from_ggml_every_leaf(files, kind, dtype):
    """Packed decoder weights ({"q", "s"[, "m"]}), densified encoder and
    embedding, f32 norms and biases: leaf for leaf and bit for bit."""
    ref, ref_cfg = jconvert.params_from_ggml(
        jread(files[kind]), dtype=getattr(jnp, dtype), keep_quantized=True)
    got, cfg = tconvert.params_from_ggml(
        tread(files[kind]), dtype=getattr(torch, dtype), keep_quantized=True,
        device="cpu")
    assert cfg.__dict__ == ref_cfg.__dict__
    fr = _flat(jax.tree_util.tree_map(np.asarray, ref))
    fg = _flat(got)
    assert fg.keys() == fr.keys()
    for name, r in fr.items():
        _assert_same_leaf(fg[name], r, name)
    packed = {n.rsplit("/", 1)[0] for n in fr if n.endswith("/q")}
    if FILE_TYPES[kind][1] is None:
        assert not packed
    else:
        # every decoder linear but the cross K/V projections
        assert len(packed) == 8, sorted(packed)
        assert not any("xk_w" in n or "xv_w" in n for n in packed)


def test_params_from_ggml_dense_and_from_jax(files):
    """keep_quantized=False densifies everything, as whisper_tpu does; and
    from_jax carries packed leaves bit for bit even when asked to cast."""
    mf = tread(files["q4_1"])
    got, _ = tconvert.params_from_ggml(mf, dtype=torch.float32,
                                       keep_quantized=False, device="cpu")
    ref, _ = jconvert.params_from_ggml(jread(files["q4_1"]),
                                       dtype=jnp.float32)
    fr = _flat(jax.tree_util.tree_map(np.asarray, ref))
    for name, r in fr.items():
        _assert_same_leaf(_flat(got)[name], r, name)
    packed, _ = jconvert.params_from_ggml(jread(files["q4_1"]),
                                          dtype=jnp.float32,
                                          keep_quantized=True)
    packed_np = jax.tree_util.tree_map(np.asarray, packed)
    bridged = _flat(tconvert.from_jax(packed_np, "cpu",
                                      dtype=torch.bfloat16))
    for name, r in _flat(packed_np).items():
        if name.endswith(("/q", "/s", "/m")):
            _assert_same_leaf(bridged[name], r, name)


def test_stub_file_gives_zero_params(tmp_path):
    """A file with no tensors (the reference's stub path) gives zero
    parameters shaped and typed as whisper_tpu's zero_params."""
    hp = dict(zip(twriter.HPARAM_KEYS, MICRO))
    path = str(tmp_path / "stub.bin")
    write_ggml(path, hp, mel_filterbank(80).astype(np.float32),
               synthetic_vocab(hp["n_vocab"]).id_to_token[:50257], {})
    got, _ = tconvert.params_from_ggml(tread(path), dtype=torch.bfloat16,
                                       device="cpu")
    ref, _ = jconvert.params_from_ggml(jread(path), dtype=jnp.bfloat16)
    fr = _flat(jax.tree_util.tree_map(np.asarray, ref))
    fg = _flat(got)
    assert fg.keys() == fr.keys()
    for name, r in fr.items():
        _assert_same_leaf(fg[name], r, name)


@pytest.mark.parametrize("kind", ["q5_0", "q5_1", "q8_0", "q4_1", "f16"])
def test_write_random_model_is_a_valid_file(kind, tmp_path):
    """chip_smoke's streamed random-weight files: whisper_tpu reads them,
    the weights that the quantize tool would quantize are in `kind` with
    std ~0.02 and mean ~0, layernorm scales are one and biases zero."""
    hp = dict(zip(twriter.HPARAM_KEYS, MICRO))
    path = str(tmp_path / "r.bin")
    twriter.write_random_model(
        path, hp, mel_filterbank(80).astype(np.float32),
        synthetic_vocab(hp["n_vocab"]).id_to_token[:50257], kind, seed=3)
    mf = jread(path)
    shapes = dict(twriter.model_tensor_shapes(hp))
    assert mf.tensors.keys() == shapes.keys()
    qtype = FILE_TYPES[kind][1]
    for name, rt in mf.tensors.items():
        arr = rt.to_numpy()
        assert arr.size == np.prod(shapes[name]), name
        if name.endswith(("ln.weight", "ln_post.weight")):
            np.testing.assert_array_equal(arr, 1.0)
        elif name.endswith(".bias"):
            np.testing.assert_array_equal(arr, 0.0)
        elif len(shapes[name]) == 2 and "positional" not in name:
            assert rt.ttype == (qtype if qtype is not None
                                else jquant.GGML_TYPE_F16), name
            assert 0.018 < arr.std() < 0.022 and abs(arr.mean()) < 3e-3, name
