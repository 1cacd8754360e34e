"""The port's multi-device decode and encode (jxl_coder_tpu_torch.parallel)
on the CPU: gloo ranks spawned by parallel.multihost.run_ranks against the
JAX package's shard_map functions on the conftest's 8 virtual devices,
and against the port's own single-device path.

One spawn of 2 ranks and one of 4 run every sharded function on the same
seeded inputs (rank_program); the tests read their results.  Each rank
returns the whole output, as the JAX functions return the global array.

Tolerances: the real-format frame within 1 code on <= size / 10000
values of the JAX sharded function (test_vardct.py's bound) and equal
(0 codes) to the port's single-device reconstruct_dct8_frame; the
round-1 XYB within 1e-5 of the JAX functions (the port's round-1 filter
tolerance, test_torch_legacy_codec.py) and equal to the port's
single-device pipeline; halos exactly.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from jxl_coder_tpu_torch import animation
from jxl_coder_tpu_torch.parallel import dryrun, groups as G, multihost
from jxl_coder_tpu_torch.vardct import dct8
from jxl_coder_tpu_torch.vardct import pipeline as P
import port_fixtures as F

TOL_F32 = 1e-5
SPAWN_TIMEOUT = 120.0
# (gab, epf, dc_smooth): test_vardct.py:161's three cases and epf_iters 0
REAL_CASES = [(True, True, True), (False, True, False), (True, 2, True),
              (True, 0, True)]
# the real stream's own filters (epf_iters 1) and EPF2 and EPF0 on top
STREAM_CASES = [(True, 1, True), (True, 2, True), (True, 3, True)]
ROUND1_CASES = [(1, True), (2, True), (0, False)]
HALOS = [1, 3, 8]


def _real_arrays(ys=16, xs=24):
    """test_vardct.py:145-160's seeded arrays."""
    from jxl_coder_tpu_torch.host.vardct import synthesis as S
    rng = np.random.default_rng(7)
    co = rng.normal(0, 20, (3, ys, xs, 64)).astype(np.float32)
    dc = rng.integers(-200, 200, (3, ys, xs)).astype(np.int32)
    qf = rng.integers(4, 40, (ys, xs)).astype(np.int32)
    sh = rng.integers(0, 8, (ys, xs)).astype(np.int32)
    xf = rng.normal(0, 0.3, (ys, xs)).astype(np.float32)
    bf = rng.normal(1.0, 0.3, (ys, xs)).astype(np.float32)
    tb = np.stack([S.dequant_table(0, c) for c in range(3)]).astype(
        np.float32)
    one = np.float32(1.0)
    return (co, dc, qf, sh, xf, bf, tb, np.float32(1.2), np.float32(0.8),
            np.asarray([0.6, 1.0, 1.5], np.float32), one, one)


def _frame_arrays():
    """test_ops_animation.py:321-330's synthetic frames."""
    r = np.random.default_rng(11)
    N, ny, nx = 8, 8, 8
    ac = r.integers(-20, 20, (N, 3, ny, nx, 8, 8)).astype(np.int32)
    dc = r.integers(-100, 100, (N, 3, ny, nx)).astype(np.int32)
    qf = np.full((N, ny, nx), 8, np.int32)
    fx = np.zeros((N, ny, nx), np.float32)
    fb = np.ones((N, ny, nx), np.float32)
    return ac, dc, qf, fx, fb


def _round1_arrays(n):
    """__graft_entry__.py:61-67's seeded arrays, 8 block rows a rank."""
    return dryrun._round1_arrays(n, np.random.default_rng(1))


def _halo_array(n):
    return np.random.default_rng(5).normal(0, 1, (3, 16 * n, 24)).astype(
        np.float32)


def _edge_only(slab, halo, mesh):
    """An exchange that sends nothing: edge replicas at every shard edge."""
    return torch.cat([slab[:, :1].expand(-1, halo, -1), slab,
                      slab[:, -1:].expand(-1, halo, -1)], 1)


def _errors(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def rank_program(mesh, streams, stream_args):
    """Every sharded function of the tests on this rank's mesh."""
    n = mesh.size
    res = {"rank": mesh.rank}
    x = torch.from_numpy(_halo_array(n))
    rows = x.shape[1] // n
    shard = x[:, mesh.rank * rows:(mesh.rank + 1) * rows]
    res["halo"] = {h: G.exchange_halo(shard, h, mesh).numpy() for h in HALOS}
    res["fixed"] = G.fix_global_halo(G.exchange_halo(shard, 3, mesh), 3,
                                     mesh).numpy()
    args = _real_arrays()
    res["real"] = {c: G.sharded_reconstruct_real(mesh, *c)(*args).numpy()
                   for c in REAL_CASES + [(True, 3, True), (False, 3, False)]}
    res["stream"] = {c: G.sharded_reconstruct_real(mesh, *c)(
        *stream_args).numpy() for c in STREAM_CASES}
    r1 = _round1_arrays(n)
    res["round1"] = {c: G.sharded_reconstruct(mesh, *c)(*r1, 1.0).numpy()
                     for c in ROUND1_CASES}
    res["frames"] = G.sharded_frame_reconstruct(mesh, 1, True)(
        *_frame_arrays(), 1.0).numpy()
    # the fault: a halo of edge replicas where the neighbours' rows belong
    real = G.exchange_halo
    G.exchange_halo = _edge_only
    try:
        res["fault"] = G.sharded_reconstruct_real(mesh, True, 2, True)(
            *args).numpy()
    finally:
        G.exchange_halo = real
    cut = list(args)          # 15 block rows
    cut[:2] = [a[:, :15] for a in args[:2]]
    cut[2:6] = [a[:15] for a in args[2:6]]
    res["errors"] = {
        "ys": _errors(lambda: G.sharded_reconstruct_real(mesh)(*cut)),
        "frames": _errors(lambda: G.sharded_frame_reconstruct(mesh)(
            *(a[:n + 1] for a in _frame_arrays()), 1.0)),
        "n_devices": _errors(lambda: G.make_mesh(n + 1, device="cpu")),
    }
    if streams:
        res["batch"] = {k: animation.decode_frames_batch(
            animation.AnimatedImage(v, mesh.device), mesh=mesh)
            for k, v in streams.items()}
    return res


@pytest.fixture(scope="module")
def streams():
    """A round-1 animation (frames wider than one group) and the real
    frames of test_ops_animation.py:177-191 by the port's encoder."""
    legacy = F.legacy_animation([np.roll(F.bench_frame(40, 264), 9 * k,
                                         axis=1) for k in range(5)])
    w, h = 128, 64
    enc = animation.AnimatedEncoder(w, h, lossless=False, quality=88,
                                    device="cpu")
    for i in range(8):
        yy, xx = np.mgrid[0:h, 0:w]
        enc.add_frame(np.clip(np.stack([yy * 2 + i * 10, xx, xx + yy], -1),
                              0, 255).astype(np.uint8), 40)
    return {"round1": legacy, "real": enc.encode()}


@pytest.fixture(scope="module")
def stream_args():
    """dct8.arguments of a 64 x 96 all-DCT8 stream (the host encoder at
    d1.0, effort 2: 8 x 12 blocks, epf_iters 1), where EPF0 acts."""
    from jxl_coder_tpu_torch import reference as R
    data = R.encode_vardct(F.bench_frame(64, 96), distance=1.0, effort=2)
    args, flt = dct8.arguments(data)
    assert flt == (True, 1, False) and args[2].shape == (8, 12)
    return args


@pytest.fixture(scope="module")
def spawned(streams, stream_args):
    """The file's processes, all started at once: rank_program at 2 ranks
    (with the animations) and at 4, and the two multi-process dry runs
    at 2 processes (each 1, then 2) -> their futures."""
    with ThreadPoolExecutor(4) as pool:
        yield {n: pool.submit(multihost.run_ranks, n, rank_program,
                              streams if n == 2 else {}, stream_args,
                              device="cpu", timeout=SPAWN_TIMEOUT)
               for n in (2, 4)} | {
            "decode": pool.submit(multihost.multihost_dryrun, 2, "cpu",
                                  timeout=SPAWN_TIMEOUT, reps=2),
            "encode": pool.submit(multihost.multihost_encode_dryrun, 2, "cpu",
                                  timeout=SPAWN_TIMEOUT, reps=1)}


@pytest.fixture(scope="module")
def jax_refs(spawned, stream_args):
    """The JAX package's outputs on the same inputs, made in this process
    on the conftest's virtual devices while the ranks run: its shard_map
    functions at 2 and 4 devices (the stream's at 2) and tpu_real's
    single-device decode of the stream at epf_iters 3."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    from jxl_coder_tpu.parallel import groups as JG
    from jxl_coder_tpu.vardct import tpu_real as TR

    def halo_fn(mesh, n, halo, fix):
        def one(s):
            padded = JG._exchange_halo(s, halo, "g")
            return JG._fix_global_halo(padded, halo, jax.lax.axis_index("g"),
                                       n) if fix else padded
        return jax.jit(JG.shard_map(one, mesh=mesh, in_specs=PS(None, "g"),
                                    out_specs=PS(None, "g")))

    out, f32 = {}, jnp.float32(1.0)
    for n in (2, 4):
        mesh = JG.make_mesh(n)
        x = jnp.asarray(_halo_array(n))
        for h in HALOS:
            out["halo", n, h] = np.asarray(halo_fn(mesh, n, h, False)(x))
        out["fixed", n] = np.asarray(halo_fn(mesh, n, 3, True)(x))
        for c in REAL_CASES:
            out["real", n, c] = np.asarray(JG.sharded_reconstruct_real(
                mesh, *c)(*_real_arrays()))
        r1 = [jnp.asarray(a) for a in _round1_arrays(n)]
        for c in ROUND1_CASES:
            out["round1", n, c] = np.asarray(JG.sharded_reconstruct(
                mesh, *c)(*r1, f32))
        out["frames", n] = np.asarray(JG.sharded_frame_reconstruct(
            mesh, 1, True)(*(jnp.asarray(a) for a in _frame_arrays()), f32))
    mesh = JG.make_mesh(2)
    for c in STREAM_CASES:
        out["stream", c] = np.asarray(JG.sharded_reconstruct_real(mesh, *c)(
            *stream_args))
    out["tpu_real_3"] = np.asarray(TR.reconstruct_dct8_frame(
        *stream_args, True, 3, False))
    return out


@pytest.fixture(scope="module")
def ranks(spawned, jax_refs):
    """rank_program's results by rank, at 2 and 4 ranks."""
    return {n: spawned[n].result() for n in (2, 4)}


def _within_code(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1 and (d > 0).sum() <= ref.size // 10000, (
        d.max(), int((d > 0).sum()))


def _within_contract(got, ref):
    """The port's decode contract: 1 code on < 0.1% of values."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (
        d.max(), float((d > 0).mean()))


def _single_real(gab, epf, dcs):
    """The port's single-device reconstruct_dct8_frame on the CPU."""
    args = dct8.to_device(*_real_arrays(), "cpu")
    return dct8.reconstruct_dct8_frame(*args.values(), gab, int(epf),
                                       not dcs).numpy()


@pytest.mark.parametrize("out", ["f32", "u8", "u16"])
@pytest.mark.parametrize("epf_iters", [0, 1, 2, 3])
def test_kernel2_window_twin_equals_the_whole_image_rows(epf_iters, out):
    """Kernel 2's row window (its plain twin on the CPU): each window's
    rows equal the same rows of the whole image, for windows at both
    edges, inside, one row tall and starting inside a block row, from
    slabs that begin before the rows it reads."""
    from jxl_coder_tpu_torch.vardct import filters
    rng = np.random.default_rng(3)
    H, W = 75, 40
    x = torch.from_numpy(rng.uniform(-0.05, 0.6, (3, H, W)).astype(
        np.float32))
    sig = torch.from_numpy(rng.uniform(0, 2.5, (10, 5)).astype(np.float32))
    gabw = (0.12, 0.05, 0.115169525, 0.061248592, 0.09, 0.07)
    whole = filters.restore_and_output(x, sig, True, epf_iters, gabw, 0.9,
                                       6.5, out)
    for r0, rows in ((0, 16), (16, 24), (40, 35), (3, 9), (61, 14),
                     (37, 1), (0, 75)):
        lo = max(0, r0 - 11) // 8 * 8
        win = filters.Window(H, lo, lo // 8, r0, rows)
        got = filters.restore_and_output(
            x[:, lo:min(H, r0 + rows + 9)], sig[lo // 8:], True, epf_iters,
            gabw, 0.9, 6.5, out, window=win)
        ref = whole[:, r0:r0 + rows] if out == "f32" else whole[r0:r0 + rows]
        assert torch.equal(got, ref), (r0, rows)


def test_kernel2_window_checks_its_slab():
    from jxl_coder_tpu_torch.vardct import filters
    x = torch.zeros((3, 40, 16))
    sig = torch.ones((5, 2))
    args = (True, 1, (0.1, 0.05) * 3, 0.9, 6.5, "u8")
    with pytest.raises(ValueError, match="does not hold"):
        filters.restore_and_output(x[:, 8:], sig, *args,
                                   window=filters.Window(40, 8, 0, 10, 8))
    with pytest.raises(ValueError, match="does not cover"):
        filters.restore_and_output(x, sig[2:], *args,
                                   window=filters.Window(40, 0, 2, 8, 8))
    with pytest.raises(ValueError, match="outside the image"):
        filters.restore_and_output(x, sig, *args,
                                   window=filters.Window(40, 0, 0, 36, 8))


@pytest.mark.parametrize("n", [2, 4])
def test_every_rank_returns_the_whole_output(ranks, n):
    res = ranks[n]
    assert [r["rank"] for r in res] == list(range(n))
    for r in res[1:]:
        for c in REAL_CASES:
            assert np.array_equal(r["real"][c], res[0]["real"][c])
        assert np.array_equal(r["frames"], res[0]["frames"])


@pytest.mark.parametrize("halo", HALOS)
@pytest.mark.parametrize("n", [2, 4])
def test_exchange_halo_equals_the_jax_ppermute(ranks, jax_refs, n, halo):
    got = np.concatenate([r["halo"][halo] for r in ranks[n]], 1)
    assert np.array_equal(got, jax_refs["halo", n, halo])


@pytest.mark.parametrize("n", [2, 4])
def test_fix_global_halo_equals_the_jax_function(ranks, jax_refs, n):
    got = np.concatenate([r["fixed"] for r in ranks[n]], 1)
    assert np.array_equal(got, jax_refs["fixed", n])


@pytest.mark.parametrize("case", REAL_CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_real_within_one_code_of_the_jax_function(ranks, jax_refs,
                                                          n, case):
    _within_code(ranks[n][0]["real"][case], jax_refs["real", n, case])


@pytest.mark.parametrize("case", REAL_CASES + [(True, 3, True),
                                               (False, 3, False)])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_real_equals_the_single_device_path(ranks, n, case):
    assert np.array_equal(ranks[n][0]["real"][case], _single_real(*case))


def test_epf3_the_jax_sharded_function_skips_epf0(stream_args, jax_refs):
    """R23: at epf_iters 3 tpu_real runs EPF0, EPF1 and EPF2; the JAX
    sharded function runs EPF1 and EPF2 only, so on a real frame it
    differs from its own single-device decode (and is its own epf_iters
    2 chain).  The port's single-device path keeps EPF0, within 1 code
    of tpu_real, and its sharded path equals it
    (test_sharded_stream_equals_the_single_device_path)."""
    at3, tpu = jax_refs["stream", (True, 3, True)], jax_refs["tpu_real_3"]
    assert (at3 != tpu).mean() > 0.1 and np.abs(
        at3.astype(int) - tpu.astype(int)).max() > 1
    assert np.array_equal(at3, jax_refs["stream", (True, 2, True)])
    port = dct8.reconstruct_dct8_frame(
        *dct8.to_device(*stream_args, "cpu").values(), True, 3,
        False).numpy()
    _within_contract(port, tpu)


@pytest.mark.parametrize("case", STREAM_CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_stream_equals_the_single_device_path(ranks, stream_args,
                                                      n, case):
    """A real frame's arrays, at epf_iters 3 too (EPF0, which the JAX
    sharded function leaves out, R23)."""
    single = dct8.reconstruct_dct8_frame(
        *dct8.to_device(*stream_args, "cpu").values(), case[0], case[1],
        not case[2]).numpy()
    assert np.array_equal(ranks[n][0]["stream"][case], single)


@pytest.mark.parametrize("case", STREAM_CASES[:2])
def test_sharded_stream_within_the_contract_of_the_jax_function(
        ranks, jax_refs, case):
    """A real frame's arrays: within the port's decode contract of the
    JAX sharded function (1 code on < 0.1% of values)."""
    _within_contract(ranks[2][0]["stream"][case], jax_refs["stream", case])


@pytest.mark.parametrize("n", [2, 4])
def test_a_wrong_halo_shows(ranks, n):
    """With edge replicas in place of the neighbours' rows the output
    differs from the single-device one: the parity test sees a halo."""
    fault = ranks[n][0]["fault"]
    single = _single_real(True, 2, True)
    assert not np.array_equal(fault, single)
    assert np.array_equal(ranks[n][0]["real"][(True, 2, True)], single)


@pytest.mark.parametrize("case", ROUND1_CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_round1_matches_the_jax_function(ranks, jax_refs, n, case):
    ref = jax_refs["round1", n, case]
    got = ranks[n][0]["round1"][case]
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL_F32
    # and the port's single-device pipeline exactly
    t = [torch.from_numpy(a) for a in _round1_arrays(n)]
    single = P._filters(P.dequant_idct(*t, 1.0), t[2], 1.0, *case, "f32")
    assert np.array_equal(got, single.numpy())


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_frames_match_the_jax_function(ranks, jax_refs, n):
    arrays = _frame_arrays()
    ref = jax_refs["frames", n]
    got = ranks[n][0]["frames"]
    assert got.shape == ref.shape == (8, 3, 64, 64)
    assert np.abs(got - ref).max() <= TOL_F32
    for f in range(8):
        t = [torch.from_numpy(a[f]) for a in arrays]
        single = P._filters(P.dequant_idct(*t, 1.0), t[2], 1.0, 1, True,
                            "f32")
        assert np.array_equal(got[f], single.numpy())


@pytest.mark.parametrize("kind", ["round1", "real"])
def test_decode_frames_batch_on_a_mesh(ranks, streams, kind):
    """decode_frames_batch(mesh=) at 2 ranks, on every rank: the non-mesh
    batch, 0 codes, and each frame's own decode (the round-1 codec's;
    get_frame for real-format frames, which leave the mesh unused)."""
    from jxl_coder_tpu_torch import codec
    img = animation.AnimatedImage(streams[kind], "cpu")
    want = animation.decode_frames_batch(img)
    for r in ranks[2]:
        assert np.array_equal(r["batch"][kind], want)
    hdr = img.image_header
    one = [codec.decode_vardct_still(img.codestream, hdr, e.header, e.toc,
                                     device="cpu") for e in img.frames] \
        if kind == "round1" else [img.get_frame(i)
                                  for i in range(img.frames_count)]
    assert np.array_equal(want, np.stack(one))


@pytest.mark.parametrize("what,match", [
    ("ys", "ValueError: an axis of 15 does not divide over"),
    ("frames", "ValueError: an axis of 3 does not divide over"),
    ("n_devices", "ValueError: n_devices 3: the process group has 2")])
def test_error_paths_raise(ranks, what, match):
    assert ranks[2][0]["errors"][what].startswith(match)


def test_a_mesh_of_two_without_a_process_group_raises(monkeypatch):
    with pytest.raises(RuntimeError, match="needs an initialised process"):
        G.make_mesh(2, device="cpu")
    mesh = G.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.device.type) == (
        1, 0, None, "cpu")
    # the default device is the card, never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.make_mesh()


def test_one_rank_without_a_group_equals_the_single_device_path():
    mesh = G.make_mesh(device="cpu")
    for case in REAL_CASES:
        got = G.sharded_reconstruct_real(mesh, *case)(*_real_arrays())
        assert np.array_equal(got.numpy(), _single_real(*case))


def test_pad_frame_arrays_equals_the_jax_function():
    from jxl_coder_tpu.parallel import groups as JG
    arrays = _frame_arrays()
    one = [a[0][:, :7] if a.ndim > 3 else a[0][:7] for a in arrays]
    got = G.pad_frame_arrays(*one, 4)
    ref = JG.pad_frame_arrays(*one, 4)
    assert got[-1] == ref[-1] == 7
    for a, b in zip(got[:-1], ref[:-1]):
        assert np.array_equal(a, b)
    assert G.pad_to_shardable(270, 4) == JG.pad_to_shardable(270, 4) == 272


def test_multihost_dryrun_two_processes(spawned):
    """Every rank's frames equal to api.decode (the workers raise if
    not)."""
    r = spawned["decode"].result()
    assert r["num_processes"] == 2 and r["fps_1proc"] > 0
    assert r["fps_nproc"] > 0 and len(r["launches"]) == 3


def test_multihost_encode_dryrun_two_processes(spawned):
    r = spawned["encode"].result()
    assert r["byte_identical"] and r["num_processes"] == 2
