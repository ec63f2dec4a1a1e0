"""Device mesh for multi-GPU data and tensor parallelism (port of
whisper_tpu.parallel.mesh).

whisper_tpu lays its params and batches on a `jax.sharding.Mesh` and lets
GSPMD insert the collectives.  Here the same layout runs SPMD over
torch.distributed, one process per card (started by `torchrun`, or by the
caller's own `init_process_group`), with the collectives written out:

  * "slice" -- optional outer data parallelism: only batch rows map to it.
  * "data"  -- batch rows (30 s windows, streams) split over data ranks.
  * "model" -- tensor parallelism (Megatron style): q/k/v, xq/xk/xv and
               mlp0 split by out-features (heads over "model"), o, xo and
               mlp2 by in-features, the decoder's tok_emb by vocab rows.
               models/whisper.py all-reduces the f32 partial products of
               o/xo/mlp2 and all-gathers the vocab-sharded logits.

Every rank calls the same entry point with the same inputs.  A call whose
batch of n rows divides over the data axes runs rows
[d*n/n_data, (d+1)*n/n_data) on data rank d and all-gathers its host
results once, in row order (`split_window_fn`); any other call runs every
row on every data group.  Either way every rank's host state advances
identically.

Two limits are whisper_tpu's: block-quantized (packed) weights are not
sharded (the packed leaf does not fit the spec tree), and every sharded
dimension (vocab rows, heads, mlp width) must divide evenly over "model".
Both raise ValueError.

Host objects travel on a gloo group of their own over every rank
(`host_group`): ContinuousBatcher's rank 0 broadcasts each iteration's
plan on it, so the other ranks replay the same admissions and batches.

Run as `torchrun --nproc-per-node N -m whisper_tpu_torch.parallel.mesh` to
check a multi-GPU box: `dryrun_multichip` decodes windows sharded and on
one device and asserts the same tokens.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist

# Per-leaf partition specs of the whisper params (whisper_tpu's
# PartitionSpecs as tuples: one entry per leading dim, an axis name or
# None; dims past the tuple are replicated).  Head-parallel attention:
# QKV out-features split, out-projection in-features split.
_ENC_BLOCK_SPECS = {
    "attn_ln_w": (), "attn_ln_b": (),
    "q_w": (None, "model", None), "q_b": (None, "model"),
    "k_w": (None, "model", None),
    "v_w": (None, "model", None), "v_b": (None, "model"),
    "o_w": (None, None, "model"), "o_b": (),
    "mlp_ln_w": (), "mlp_ln_b": (),
    "mlp0_w": (None, "model", None), "mlp0_b": (None, "model"),
    "mlp2_w": (None, None, "model"), "mlp2_b": (),
}
_DEC_BLOCK_SPECS = dict(_ENC_BLOCK_SPECS)
_DEC_BLOCK_SPECS.update({
    "xattn_ln_w": (), "xattn_ln_b": (),
    "xq_w": (None, "model", None), "xq_b": (None, "model"),
    "xk_w": (None, "model", None),
    "xv_w": (None, "model", None), "xv_b": (None, "model"),
    "xo_w": (None, None, "model"), "xo_b": (),
})


class Mesh:
    """One rank's view of a ("data", "model") or ("slice", "data",
    "model") mesh: its axis names, `shape` (a dict, like
    jax.sharding.Mesh.shape), this rank's coordinates, the process group
    of each axis (`groups`, plus `data_group` over the data axes
    together), the torch DeviceMesh, the device this rank computes on and
    `host_group`, a gloo group over every rank for host objects.
    """

    def __init__(self, axis_names, shape, coords, device, backend, groups,
                 data_group, device_mesh=None, host_group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.device = torch.device(device)
        self.backend = backend
        self.groups = dict(groups)
        self.data_group = data_group
        self.device_mesh = device_mesh
        self.host_group = host_group

    @property
    def n_model(self) -> int:
        return self.shape["model"]

    @property
    def n_data(self) -> int:
        """Ranks the batch rows split over: data x slice."""
        return self.shape["data"] * self.shape.get("slice", 1)

    @property
    def model_rank(self) -> int:
        return self.coords["model"]

    @property
    def data_rank(self) -> int:
        """This rank's position over the data axes, slice-major."""
        return self.coords.get("slice", 0) * self.shape["data"] \
            + self.coords["data"]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend!r})")

    # -- collectives -----------------------------------------------------

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over "model", in place; returns it."""
        dist.all_reduce(t, group=self.groups["model"])
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The "model" ranks' `t` concatenated along `dim` in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.n_model)]
        dist.all_gather(parts, t, group=self.groups["model"])
        return torch.cat(parts, dim=dim)

    def gather_objects(self, obj) -> list:
        """Every data rank's `obj` (picklable host data), in data-rank
        order."""
        if self.n_data == 1:
            return [obj]
        out = [None] * self.n_data
        dist.all_gather_object(out, obj, group=self.data_group)
        return out

    def broadcast_object(self, obj=None):
        """Rank 0's `obj` (picklable host data) on every rank; the other
        ranks pass nothing and wait for it.  On `host_group` (gloo), so
        the wait is on the host and the size need not be known up front."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        return box[0]

    def any_rank(self, flag: bool) -> bool:
        """Whether `flag` holds on any rank (a host all-reduce on
        `host_group`)."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())


def make_mesh(n_data: int = 1, n_model: int = 1, n_slice: int = 1,
              device=None, *, backend: str | None = None,
              init_method: str | None = None, world_size: int | None = None,
              rank: int | None = None) -> Mesh:
    """Build this rank's mesh of n_slice x n_data x n_model processes.

    device: "cuda:{LOCAL_RANK}" by default, or the CPU when the caller
    asks for it.  backend: NCCL on CUDA and gloo on the CPU, or gloo when
    named (two ranks on one card: NCCL refuses a duplicate GPU); an
    already-initialized process group must run the same backend.  The
    process group is initialized here when it is not yet (init_method,
    world_size and rank as init_process_group takes them; env:// by
    default, as torchrun sets it up).  The world must hold exactly
    n_slice * n_data * n_model ranks; rank r sits at coordinates
    (r // (n_data * n_model), r // n_model % n_data, r % n_model)."""
    if n_slice > 1:
        names, dims = ("slice", "data", "model"), (n_slice, n_data, n_model)
    else:
        names, dims = ("data", "model"), (n_data, n_model)
    if min(dims) < 1:
        raise ValueError(f"mesh axes must be >= 1, got "
                         f"{dict(zip(names, dims))}")
    n = math.prod(dims)
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} asked for, but CUDA "
                               "is not available")
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kw = {k: v for k, v in (("init_method", init_method),
                                ("world_size", world_size), ("rank", rank))
              if v is not None}
        dist.init_process_group(backend, **kw)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    if world > n:
        raise ValueError(f"the mesh {dict(zip(names, dims))} takes {n} "
                         f"ranks, the world has {world}")

    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device.type, dims, mesh_dim_names=names)
    groups = {name: dm.get_group(name) for name in names}
    coords = dict(zip(names, dm.get_coordinate()))
    data_group = groups["data"]
    if n_slice > 1:
        # the data axes together: one group a model column, made by every
        # rank in the same order
        for m in range(n_model):
            g = dist.new_group([r for r in range(n) if r % n_model == m])
            if m == coords["model"]:
                data_group = g
    # host objects: gloo whatever the backend (NCCL would need CUDA
    # tensors of a size known up front)
    host_group = dist.new_group(backend="gloo")
    return Mesh(names, dict(zip(names, dims)), coords, device, backend,
                groups, data_group, dm, host_group)


def data_axes(mesh: Mesh):
    """The axis (or axis tuple) batch dims split over."""
    return ("slice", "data") if "slice" in mesh.axis_names else "data"


def param_specs(params) -> dict:
    """The spec tree matching the whisper params tree."""
    enc = {k: () for k in params["encoder"] if k != "blocks"}
    enc["blocks"] = {k: _ENC_BLOCK_SPECS[k]
                     for k in params["encoder"]["blocks"]}
    dec = {k: () for k in params["decoder"] if k != "blocks"}
    # vocab-sharded embedding: the logit product becomes column-parallel
    dec["tok_emb"] = ("model", None)
    dec["blocks"] = {k: _DEC_BLOCK_SPECS[k]
                     for k in params["decoder"]["blocks"]}
    return {"encoder": enc, "decoder": dec}


def batch_spec(mesh: Mesh) -> tuple:
    """Activations: batch over the data axes, replicated over "model"."""
    return (data_axes(mesh),)


def kv_spec(mesh: Mesh) -> tuple:
    """KV layout (L, B, H, Dh, T): batch over the data axes, heads over
    "model".  Each rank holds (L, B_local, H_local, Dh, T) of the
    cross-KV (T = Ta) and of the self-attention cache (T = C): the k/v
    projections' out-features are "model"-split, so a rank attends over
    its own heads with no collective until the out-projection's
    all-reduce."""
    return (None, data_axes(mesh), "model", None, None)


def _local_leaf(x, spec, coords, mesh_shape, name):
    if isinstance(x, dict):
        raise ValueError(f"{name}: block-quantized (packed) weights cannot "
                         "be sharded over a mesh; load the model with "
                         "keep_quantized=False")
    for dim, axis in enumerate(spec):
        n = mesh_shape.get(axis, 1)
        if axis is None or n == 1:
            continue
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"{name}: dimension {dim} of size {size} does "
                             f"not divide over {axis}={n}")
        part = size // n
        x = x.narrow(dim, coords.get(axis, 0) * part, part)
    return x


def local_shard(params, coords: dict, mesh_shape: dict) -> dict:
    """The leaves of `params` that the rank at mesh coordinates `coords`
    holds (views where a leaf is split; no process group needed)."""
    specs = param_specs(params)

    def walk(tree, spec, prefix):
        return {k: (walk(v, spec[k], f"{prefix}{k}/")
                    if isinstance(spec[k], dict)
                    else _local_leaf(v, spec[k], coords, mesh_shape,
                                     prefix + k))
                for k, v in tree.items()}
    return walk(params, specs, "")


class ShardedParams(dict):
    """A params tree holding one rank's shard, and the mesh it belongs to
    (models/whisper.py runs its collectives over `mesh`)."""

    mesh: Mesh


def shard_params(params, mesh: Mesh) -> ShardedParams:
    """This rank's shard of `params` on mesh.device.  A split leaf is a
    fresh contiguous copy, so nothing of the whole tensor stays alive
    through it; replicated leaves move as they are.  Params already
    sharded over `mesh` come back unchanged."""
    held = getattr(params, "mesh", None)
    if held is mesh:
        return params
    if held is not None:
        raise ValueError("params are already sharded over another mesh")
    local = local_shard(params, mesh.coords, mesh.shape)

    def place(tree, whole):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = place(v, whole[k])
            elif v is whole[k]:
                out[k] = v.to(mesh.device)
            else:
                out[k] = v.to(mesh.device, copy=True,
                              memory_format=torch.contiguous_format)
        return out
    out = ShardedParams(place(local, params))
    out.mesh = mesh
    return out


# ---------------------------------------------------------------------------
# row splitting over the data axes
# ---------------------------------------------------------------------------

def row_slice(mesh: Mesh | None, n: int) -> slice | None:
    """This rank's rows of an n-row batch when they split over the data
    axes (n % n_data == 0), else None: every data group runs all n rows
    (a serial `full`, whose 1 or best_of rows need not divide)."""
    if mesh is None or mesh.n_data == 1 or n % mesh.n_data:
        return None
    k = n // mesh.n_data
    return slice(mesh.data_rank * k, (mesh.data_rank + 1) * k)


def local_rows(x, n: int, sl: slice, dim: int = 1):
    """The rows `sl` of a batch of n along `dim` (a tensor, or a tuple of
    tensors such as (codes, scales)); a batch already at the local row
    count is returned as it is."""
    if isinstance(x, (tuple, list)):
        return type(x)(local_rows(a, n, sl, dim) for a in x)
    size = x.shape[dim]
    if size == n:
        return x.narrow(dim, sl.start, sl.stop - sl.start)
    if size != sl.stop - sl.start:
        raise ValueError(f"a batch of {size} rows is neither the whole "
                         f"{n} nor this rank's {sl.stop - sl.start}")
    return x


def gather_rows(mesh: Mesh, parts) -> np.ndarray | dict:
    """All-gather a rank's host rows over the data axes, in row order: a
    numpy array (rows first) or a window-result dict (per-row arrays
    concatenate, the batch-global step count n_tokens takes the max)."""
    got = mesh.gather_objects(parts)
    if not isinstance(parts, dict):
        return np.concatenate(got, axis=0)
    return {key: (np.int32(max(int(g[key]) for g in got))
                  if key == "n_tokens"
                  else np.concatenate([g[key] for g in got], axis=0))
            for key in parts}


def split_window_fn(fn, mesh: Mesh, n_rows: int):
    """A window-decode fn of n_rows rows (decode/loop.py's greedy window,
    or decode/beam.py's batched beam window, n_rows streams) whose rows
    split over the data axes: it takes the whole batch's host inputs and
    the whole or this rank's cross-KV rows, decodes this rank's rows with
    `fn` (built for n_rows / n_data rows) and all-gathers the results.
    Per-row keys (n, 2) go with their rows, so draws at t > 0 are those of
    the unsplit batch; a single (2,) key stream is not split."""
    sl = row_slice(mesh, n_rows)
    if sl is None:
        return fn

    def run(params, k_cross, v_cross, prompt, pad_len, temperature, seek,
            seek_end, rng_key=None, row_live=None):
        def rows(a, ndim):
            a = np.asarray(a)
            return a[sl] if a.ndim == ndim else a
        if rng_key is not None and np.asarray(rng_key).ndim != 2:
            raise ValueError("a row-split window needs per-row keys")
        out = fn(params, local_rows(k_cross, n_rows, sl),
                 local_rows(v_cross, n_rows, sl), rows(prompt, 2),
                 rows(pad_len, 1), temperature, rows(seek, 1),
                 rows(seek_end, 1),
                 None if rng_key is None else rows(rng_key, 2),
                 None if row_live is None else rows(row_live, 1))
        return gather_rows(mesh, out)
    return run


# ---------------------------------------------------------------------------
# the multi-GPU dry run
# ---------------------------------------------------------------------------

def _dryrun_shape(n: int) -> tuple[int, int, int]:
    """(n_slice, n_data, n_model) of whisper_tpu's dry run for n ranks."""
    n_slice = 2 if n % 4 == 0 and n >= 8 else 1
    n_model = 2 if n % 2 == 0 else 1
    return n_slice, n // (n_model * n_slice), n_model


def dryrun_multichip(mesh: Mesh) -> dict:
    """The production window decode, sharded over `mesh` against one
    device, token for token at float32 (whisper_tpu's
    __graft_entry__.dryrun_multichip): the greedy window with a dead row,
    the serial beam (replicated rows, heads over "model") and the
    pre-quantized int8 cross-KV window.  Every rank calls it; each runs
    the unsharded reference on its own device.  -> the step counts."""
    from ..decode.beam import make_beam_decode_window
    from ..decode.filters import FilterConsts, FilterOptions
    from ..decode.loop import LoopConfig, make_decode_window
    from ..models import whisper as wm
    from ..models.whisper import WhisperConfig
    from ..weights.convert import random_params

    dev = mesh.device
    cfg = WhisperConfig(
        n_vocab=512, n_audio_ctx=32, n_audio_state=128, n_audio_head=8,
        n_audio_layer=2, n_text_ctx=32, n_text_state=128, n_text_head=8,
        n_text_layer=2, n_mels=80, model_type="dryrun")
    # small-vocab filter constants (the real tokenizer's field roles)
    consts = FilterConsts(
        n_vocab=512, token_eot=500, token_sot=501, token_beg=320,
        token_not=319, token_nosp=318, token_solm=317, token_prev=316,
        token_translate=315, token_transcribe=314, token_space=220,
        lang_ids=(502, 503), nst_ids=(), precision=30.0 / cfg.n_audio_ctx)
    f32 = torch.float32
    lcfg = LoopConfig(
        n_head=cfg.n_text_head, n_text_ctx=cfg.n_text_ctx, prompt_size=8,
        max_tokens_loop=cfg.n_text_ctx // 2 - 4, max_tokens_param=0,
        single_segment=False, no_timestamps=False, compute_dtype=f32,
        cross_mode="einsum")
    params = random_params(cfg, seed=0, dtype=f32, device=dev)
    sharded = shard_params(params, mesh)

    B = 2 * mesh.n_data                  # two windows a data rank
    PR = lcfg.prompt_size
    rng = np.random.RandomState(0)
    mel_h = rng.randn(B, 2 * cfg.n_audio_ctx, cfg.n_mels).astype(np.float32)
    prompt_h = np.zeros((B, PR), np.int32)
    prompt_h[:, -3:] = [501, 502, 314]   # sot, lang, transcribe
    pad_h = np.full((B,), PR - 3, np.int32)
    live_h = np.ones((B,), bool)
    live_h[-1] = False                   # a dead row
    keys = np.zeros((B, 2), np.uint32)
    seeks, ends = np.zeros((B,), np.int32), np.full((B,), 3000, np.int32)

    def encode_xkv(p, mel, cross_fn):
        # the plain attention on any device: K1 takes bf16 only
        enc = wm.encode(p, mel, n_head=cfg.n_audio_head, compute_dtype=f32,
                        attn_impl="einsum")
        return cross_fn(p, enc, n_head=cfg.n_text_head, compute_dtype=f32)

    def window(lc, cross_fn, split):
        fn = make_decode_window(consts=consts, options=FilterOptions(),
                                cfg=lc, device=dev)
        p, mel = params, mel_h
        if split:
            fn = split_window_fn(fn, mesh, B)
            sl = row_slice(mesh, B)
            p, mel = sharded, mel_h if sl is None else mel_h[sl]
        with torch.no_grad():
            kc, vc = encode_xkv(p, torch.from_numpy(mel).to(dev), cross_fn)
        return fn(p, kc, vc, prompt_h, pad_h, 0.0, seeks, ends, keys,
                  live_h)

    steps = {}
    for name, lc, cross_fn in (
            ("greedy", lcfg, wm.cross_kv),
            ("q8", dataclasses.replace(lcfg, cross_mode="einsum_q8"),
             wm.cross_kv_q8)):
        ref, out = window(lc, cross_fn, False), window(lc, cross_fn, True)
        if int(ref["n_tokens"]) <= 0:
            raise AssertionError(f"{name}: no tokens decoded")
        for key in ("tokens", "result_len", "seek_delta", "completed"):
            np.testing.assert_array_equal(out[key], ref[key],
                                          err_msg=f"{name} {key}")
        if not (out["completed"][-1] and out["tokens"][-1, 0] == 500):
            raise AssertionError("a dead row must start completed and stay "
                                 "EOT")
        steps[name] = int(ref["n_tokens"])

    # the serial beam: its coupled rows run on every data group
    n_beam = max(2, mesh.n_data)
    bp_h = np.zeros((n_beam, PR), np.int32)
    bp_h[:, -3:] = [501, 502, 314]
    bpad_h = np.full((n_beam,), PR - 3, np.int32)
    mel_b = torch.from_numpy(mel_h[:1]).to(dev)
    beam = make_beam_decode_window(consts=consts, options=FilterOptions(),
                                   cfg=lcfg, beam_size=n_beam, device=dev)
    outs = []
    for p in (params, sharded):
        with torch.no_grad():
            kc, vc = encode_xkv(p, mel_b, wm.cross_kv)
        kc = kc.expand((kc.shape[0], n_beam) + kc.shape[2:])
        vc = vc.expand((vc.shape[0], n_beam) + vc.shape[2:])
        outs.append(beam(p, kc, vc, bp_h, bpad_h, 0.0, 0, 3000, None))
    ref, out = outs
    if int(ref["n_tokens"]) <= 0:
        raise AssertionError("beam: no tokens decoded")
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])
    np.testing.assert_array_equal(out["result_len"], ref["result_len"])
    steps["beam"] = int(ref["n_tokens"])
    return steps


def main() -> None:
    """`torchrun --nproc-per-node N -m whisper_tpu_torch.parallel.mesh
    [--device cpu]`: the dry run over whisper_tpu's mesh for N ranks."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default cuda:LOCAL_RANK)")
    args = ap.parse_args()
    n_slice, n_data, n_model = _dryrun_shape(
        int(os.environ.get("WORLD_SIZE", 1)))
    if "RANK" not in os.environ:   # a plain `python -m`: one rank
        os.environ.setdefault("MASTER_ADDR", "localhost")
        os.environ.setdefault("MASTER_PORT", "29511")
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    mesh = make_mesh(n_data, n_model, n_slice, device=args.device)
    steps = dryrun_multichip(mesh)
    if dist.get_rank() == 0:
        print(f"dryrun_multichip: OK on {dist.get_world_size()} ranks "
              f"(mesh {mesh.shape}, {mesh.backend}): sharded windows match "
              f"one device token for token (greedy {steps['greedy']} steps, "
              f"q8 cross-KV {steps['q8']}, beam-{max(2, mesh.n_data)} "
              f"{steps['beam']})", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
