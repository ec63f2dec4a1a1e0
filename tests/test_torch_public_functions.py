"""The port's copies of whisper_tpu's remaining public functions against
whisper_tpu's own, on the same inputs: tokenizer.detokenize over a
write_model vocab (special ids skipped and kept), tokenizer.hf_token_to_bytes
over every byte of the GPT-2 byte table, and
ops/quantized.dequantize_weights over q4_0, q5_1 and q8_0 codes, with and
without mins, to bf16 and f32 (bit for bit)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_ggml import write_model  # noqa: E402
from whisper_tpu import tokenizer as jtok  # noqa: E402
from whisper_tpu.ops import quantized as jq  # noqa: E402
from whisper_tpu.weights import quant  # noqa: E402
from whisper_tpu.weights.ggml_reader import read_ggml_file as jread  # noqa: E402
from whisper_tpu_torch import tokenizer as ttok  # noqa: E402
from whisper_tpu_torch.ops import quantized as tq  # noqa: E402
from whisper_tpu_torch.weights.ggml_reader import read_ggml_file as tread  # noqa: E402


@pytest.fixture(scope="module")
def vocabs(tmp_path_factory):
    path = write_model(tmp_path_factory.mktemp("fns") / "f32.bin", "f32")
    return jread(path).vocab, tread(path).vocab


@pytest.mark.parametrize("skip_special", [True, False])
def test_detokenize(vocabs, skip_special):
    jv, tv = vocabs
    rng = np.random.RandomState(4)
    eot = tv.token_eot
    assert eot == jv.token_eot
    ids = np.concatenate([rng.randint(0, eot, 40),
                          [eot, tv.token_sot, eot + 5, tv.n_vocab - 1],
                          rng.randint(0, tv.n_vocab, 20)])
    rng.shuffle(ids)
    got = ttok.detokenize(tv, ids, skip_special=skip_special)
    assert got == jtok.detokenize(jv, ids, skip_special=skip_special)
    assert len(got) > 0
    # numpy ids and Python ints alike
    assert ttok.detokenize(tv, [int(i) for i in ids], skip_special) == got


def test_hf_token_to_bytes_every_byte():
    table = ttok._bytes_to_unicode()
    assert table == jtok._bytes_to_unicode()
    assert sorted(table) == list(range(256))
    # every printable GPT-2 character alone, then all of them as one token
    for b, ch in table.items():
        assert ttok.hf_token_to_bytes(ch) == jtok.hf_token_to_bytes(ch) == \
            bytes([b])
    word = "".join(table[b] for b in range(256))
    assert ttok.hf_token_to_bytes(word) == jtok.hf_token_to_bytes(word) == \
        bytes(range(256))
    assert ttok.hf_token_to_bytes("Ġhello") == b" hello"
    with pytest.raises(KeyError):
        ttok.hf_token_to_bytes("一")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("qtype,mins", [
    (quant.GGML_TYPE_Q4_0, False), (quant.GGML_TYPE_Q8_0, False),
    (quant.GGML_TYPE_Q5_1, True), (quant.GGML_TYPE_Q5_1, False)],
    ids=["q4_0", "q8_0", "q5_1-mins", "q5_1-no-mins"])
def test_dequantize_weights(qtype, mins, dtype):
    N, K = 96, 256
    rng = np.random.RandomState(qtype)
    w = (rng.randn(N, K) * 0.05 + 0.01).astype(np.float32)
    codes, scales, m = jq.unpack_to_codes(quant.QUANTIZERS[qtype](w), qtype,
                                          (N, K))
    assert (m is not None) == (qtype == quant.GGML_TYPE_Q5_1)
    if not mins:
        m = None
    want = jq.dequantize_weights(jnp.asarray(codes), jnp.asarray(scales),
                                 None if m is None else jnp.asarray(m),
                                 dtype=getattr(jnp, dtype))
    got = tq.dequantize_weights(torch.from_numpy(codes),
                                torch.from_numpy(scales),
                                None if m is None else torch.from_numpy(m),
                                dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (N, K)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    if mins:   # the mins moved the weights
        assert not np.array_equal(
            got.float().numpy(),
            tq.dequantize_weights(torch.from_numpy(codes),
                                  torch.from_numpy(scales),
                                  dtype=getattr(torch, dtype)).float().numpy())
