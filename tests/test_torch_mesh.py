"""parallel/mesh.py: the port's device mesh against whisper_tpu's.

The layout: every leaf of the port's `local_shard` at a mesh coordinate
equals the shard whisper_tpu's `shard_params` places on the device at that
coordinate of the virtual 8-device CPU mesh (tests/conftest.py).  The
refusals: both packages refuse packed params, a vocab that does not divide
over "model", and a batch that does not divide over the data axes.  The
runs: 4 gloo ranks on the CPU (spawned processes, a file:// rendezvous,
each test with its own deadline) give whisper_tpu's mesh segments and the
port's unsharded ones at float32, token for token.
"""

import multiprocessing
import os
import pickle
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torch_mesh_worker as worker  # noqa: E402
from test_torch_ggml import write_model  # noqa: E402
from whisper_tpu.api import WhisperContext as JaxContext  # noqa: E402
from whisper_tpu.parallel import mesh as jmesh  # noqa: E402
from whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch  # noqa: E402
from whisper_tpu_torch.api import WhisperContext  # noqa: E402
from whisper_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from whisper_tpu_torch.parallel.batch import BatchTranscriber  # noqa: E402

# tests/test_mesh.py's model: d = 128, 8 heads, a vocab of 51864 (the
# .en models': it divides over "model" up to 8)
DIMS = (51864, 64, 128, 8, 2, 48, 128, 8, 3, 80)
# test_mesh's params: one segment a window, 5 tokens, no ladder
OVERRIDES = dict(single_segment=True, max_tokens=5, temperature_inc=0.0,
                 language="en")
DEADLINE = 240.0   # seconds a 4-rank run may take
needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("mesh") / "f32.bin", "f32",
                       dims=DIMS, seed=3)


@pytest.fixture(scope="module")
def streams():
    return [(np.random.RandomState(s).randn(16000 * 2) * 0.1)
            .astype(np.float32) for s in range(4)]


def _jax_params(overrides):
    from whisper_tpu.api import full_default_params
    p = full_default_params()
    p.print_progress = False
    for k, v in overrides.items():
        setattr(p, k, v)
    return p


def _jax_segments(result):
    return [[(s.t0, s.t1, tuple(t.id for t in s.tokens)) for s in segs]
            for segs in result]


def _ids(segs):
    """Drop t_dtw from worker.segments' tuples."""
    return [[s[:3] for s in stream] for stream in segs]


def _ranks(tmp_path, shape, job, **kwargs):
    """Run `job` on n_data x n_model x n_slice gloo ranks; -> each rank's
    result.  Fails on a rank's error and at the deadline (the ranks are
    terminated)."""
    world = int(np.prod(shape))
    out_dir = tmp_path / f"out_{job}"
    out_dir.mkdir()
    spawn = multiprocessing.get_context("spawn")
    procs = [spawn.Process(target=worker.run,
                           args=(r, world, str(tmp_path / f"rdv_{job}"),
                                 shape, job, kwargs, str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + DEADLINE
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not late, f"ranks {late} still running after {DEADLINE} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    results = []
    for r in range(world):
        path = out_dir / f"rank{r}.pkl"
        assert path.exists(), f"rank {r} exited {procs[r].exitcode}"
        res = pickle.loads(path.read_bytes())
        assert "error" not in res, f"rank {r}:\n{res['error']}"
        results.append(res)
    return results


# ---------------------------------------------------------------------------
# layout and refusals, in process
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@needs8
@pytest.mark.parametrize("shape", [(2, 2, 1), (1, 4, 1), (1, 2, 2)],
                         ids=["2x2", "1x4", "2x1x2"])
def test_local_shard_is_the_jax_shard(model, shape):
    n_data, n_model, n_slice = shape
    jctx = JaxContext.from_file(model, compute_dtype=jnp.float32)
    tparams = WhisperContext.from_file(model, compute_dtype=torch.float32,
                                       device="cpu").params
    mesh = jmesh.make_mesh(n_data=n_data, n_model=n_model, n_slice=n_slice)
    jflat = _flat(jmesh.shard_params(jctx.params, mesh))
    devices = mesh.devices
    n_checked = 0
    for coords_idx in np.ndindex(devices.shape):
        coords = dict(zip(mesh.axis_names, coords_idx))
        local = _flat(tmesh.local_shard(tparams, coords, dict(mesh.shape)))
        assert local.keys() == jflat.keys()
        dev = devices[coords_idx]
        for name, arr in jflat.items():
            shard, = [s for s in arr.addressable_shards if s.device == dev]
            np.testing.assert_array_equal(local[name].numpy(),
                                          np.asarray(shard.data),
                                          err_msg=f"{name} at {coords}")
            n_checked += 1
    assert n_checked == len(jflat) * devices.size


@needs8
def test_refusals_match_jax(tmp_path):
    jm = jmesh.make_mesh(n_data=2, n_model=2)
    at = ({"data": 0, "model": 0}, {"data": 2, "model": 2})
    # packed (block-quantized) weights do not fit the spec tree
    q8 = write_model(tmp_path / "q8.bin", "q8_0", dims=DIMS)
    from whisper_tpu.weights.convert import params_from_ggml
    from whisper_tpu.weights.ggml_reader import read_ggml_file
    jpacked, _ = params_from_ggml(read_ggml_file(q8), keep_quantized=True)
    with pytest.raises(ValueError):
        jmesh.shard_params(jpacked, jm)
    tpacked = WhisperContext.from_file(q8, device="cpu").params
    with pytest.raises(ValueError, match="packed"):
        tmesh.local_shard(tpacked, *at)
    # the multilingual vocab (51865) does not divide over model = 2
    odd = (51865,) + DIMS[1:]
    jctx = JaxContext.from_random(dims=odd, compute_dtype=jnp.float32)
    with pytest.raises(ValueError, match="divisible"):
        jmesh.shard_params(jctx.params, jm)
    with pytest.raises(ValueError, match="divide"):
        tmesh.local_shard(WhisperContext.from_jax(jctx, "cpu").params, *at)
    # a batch that does not divide over the data axes
    with pytest.raises(AssertionError, match="divide"):
        JaxBatch(jctx, batch_size=3, mesh=jm)
    view = tmesh.Mesh(("data", "model"), {"data": 2, "model": 2},
                      {"data": 0, "model": 0}, "cpu", "gloo", {}, None)
    tctx = WhisperContext.from_random(dims=DIMS, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        BatchTranscriber(tctx, batch_size=3, mesh=view)
    assert tctx.mesh is None
    # nor do 8 heads over model = 3 (the vocab does)
    with pytest.raises(ValueError, match="q_w: dimension 1 of size 128"):
        tmesh.local_shard(tctx.params, {"data": 0, "model": 0},
                          {"data": 1, "model": 3})
    # the layout helpers name whisper_tpu's axes
    assert tmesh.kv_spec(view) == (None, "data", "model", None, None)
    assert tmesh.batch_spec(view) == ("data",)
    assert tuple(jmesh.kv_spec(jm)) == tmesh.kv_spec(view)


def test_row_slice_and_local_rows():
    view = tmesh.Mesh(("slice", "data", "model"),
                      {"slice": 2, "data": 2, "model": 1},
                      {"slice": 1, "data": 0, "model": 0}, "cpu", "gloo", {},
                      None)
    assert view.n_data == 4 and view.data_rank == 2
    assert tmesh.row_slice(view, 8) == slice(4, 6)
    assert tmesh.row_slice(view, 6) is None      # runs on every data group
    assert tmesh.row_slice(None, 8) is None
    x = torch.arange(3 * 8).reshape(3, 8)
    assert tmesh.local_rows(x, 8, slice(4, 6)).tolist() == \
        x[:, 4:6].tolist()
    assert tmesh.local_rows(x[:, :2], 8, slice(4, 6)).shape == (3, 2)
    with pytest.raises(ValueError):
        tmesh.local_rows(x[:, :3], 8, slice(4, 6))


# ---------------------------------------------------------------------------
# runs on 4 gloo ranks
# ---------------------------------------------------------------------------

@needs8
@pytest.mark.parametrize("shape", [(2, 2, 1), (1, 2, 2)],
                         ids=["2x2", "2x1x2"])
def test_batch_on_mesh_matches_jax_and_unsharded(model, streams, tmp_path,
                                                  shape):
    """BatchTranscriber on 4 streams over the mesh: whisper_tpu's mesh
    segments and the port's mesh=None ones; then a serial full() on the
    mesh-attached context equals stream 0 (its one row runs on every data
    group)."""
    n_data, n_model, n_slice = shape
    jctx = JaxContext.from_file(model, compute_dtype=jnp.float32)
    want = _jax_segments(JaxBatch(
        jctx, batch_size=4, params=_jax_params(OVERRIDES),
        mesh=jmesh.make_mesh(n_data=n_data, n_model=n_model,
                             n_slice=n_slice)).transcribe(streams))
    assert all(want), want
    tctx = worker.load(model, {})
    bt = BatchTranscriber(tctx, batch_size=4,
                          params=worker._params(dict(OVERRIDES)))
    unsharded = _ids(worker.segments(bt.transcribe(streams)))
    assert unsharded == want
    for res in _ranks(tmp_path, shape, "batch", path=model, streams=streams,
                      overrides=OVERRIDES):
        got = res["ok"]
        assert got["heads"] == DIMS[6] // n_model   # this rank's shard
        assert _ids(got["batch"]) == want, res["coords"]
        assert [s[:3] for s in got["serial"]] == want[0]


def test_sharded_encode_matches_replicated(model, tmp_path):
    """encode() over params split 1 x 4 (two heads a rank), in every
    attention impl the CPU runs, within 2e-4 of the whole params'."""
    mel = np.random.RandomState(0).randn(2, 2 * DIMS[1], DIMS[9]) \
        .astype(np.float32)
    impls = ["einsum", "pallas_interpret", "pallas_dt_interpret",
             "pallas_pf_interpret", "pallas_btd_interpret"]
    for res in _ranks(tmp_path, (1, 4, 1), "encode", path=model, mel=mel,
                      impls=impls):
        for impl, err in res["ok"].items():
            assert err < 2e-4, (impl, err, res["coords"])


def test_dryrun_multichip(tmp_path):
    """The port's dry run on 4 ranks: whisper_tpu's shape for 4 devices,
    data 2 x model 2."""
    results = _ranks(tmp_path, (2, 2, 1), "dryrun")
    steps = results[0]["ok"]
    assert all(r["ok"] == steps for r in results)
    assert min(steps.values()) > 0


# the batched beam (2 streams x 2 beams: the streams split over data, a
# stream's beams on one rank); DTW token timestamps whose alignment heads
# lie on both model shards; the ladder forced through every rung
# (logprob_thold 5 fails every window), best_of 2 tiled in the batch and
# best_of 5 over passes of 4 rows, its per-row keys split with their rows
RUNS = {
    "beam": (dict(OVERRIDES, beam_size=2), {}),
    "dtw": (OVERRIDES, dict(dtw_token_timestamps=True,
                            dtw_aheads_preset="custom",
                            dtw_aheads=[(0, 1), (1, 6), (2, 3), (2, 7)])),
    "ladder": (dict(OVERRIDES, temperature_inc=0.5, logprob_thold=5.0,
                    no_speech_thold=2.0, best_of=2), {}),
    "multipass": (dict(OVERRIDES, temperature_inc=0.5, logprob_thold=5.0,
                       no_speech_thold=2.0, best_of=5), {}),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_decode_forms_on_mesh(model, streams, tmp_path, run):
    """Each form on 2 x 2 equals the port's unsharded run."""
    overrides, ctx_kwargs = RUNS[run]
    tctx = worker.load(model, ctx_kwargs)
    bt = BatchTranscriber(tctx, batch_size=4,
                          params=worker._params(dict(overrides)))
    want = worker.segments(bt.transcribe(streams[:2]))
    assert all(want), want
    if run == "dtw":
        # each stream's text tokens are stamped (timestamps keep -1)
        assert all(any(t >= 0 for s in segs for t in s[3])
                   for segs in want)
    if run in ("ladder", "multipass"):
        assert bt.n_retried_windows == bt.n_windows > 0
    for res in _ranks(tmp_path, (2, 2, 1), "batch", path=model,
                      streams=streams[:2], overrides=overrides,
                      ctx_kwargs=ctx_kwargs, serial=False):
        assert res["ok"]["batch"] == want, res["coords"]
