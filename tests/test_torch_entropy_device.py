"""The port's device AC entropy decode (jxl_coder_tpu_torch.entropy.device)
on the CPU, against the JAX package's (jxl_coder_tpu.entropy.device) and
the host decoder.

Streams come from the port's host encoder and from the JAX package's
encode_vardct_real: multi-group frames with many strategy families, a
dense d0.1 frame, a two-pass (progressive) frame and single-section
frames.  The twin (decode_pass_groups_plain) reads one token per group a
step, so its streams are smooth waves with a band of sharp bars: few
tokens, many families.  The kernel's own token step (csrc/entropy.cuh)
is built with g++ and decodes noisier, denser streams too.  Every
comparison of coefficients is exact; pixels of the two routes of the
port are equal, and within the decode contract of the JAX package's
(its reconstruction rounds otherwise: tests/test_torch_decode.py).
"""

import ctypes
import functools
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from jxl_coder_tpu import api as ref_api
from jxl_coder_tpu.entropy import device as REF
from jxl_coder_tpu.vardct import dec_real as REF_DR
from jxl_coder_tpu.vardct.enc_real import encode_vardct_real as jax_encode
from jxl_coder_tpu_torch import _build, api, reference
from jxl_coder_tpu_torch.entropy import device as ENT
from jxl_coder_tpu_torch.host.api import InvalidJXLError
from jxl_coder_tpu_torch.vardct import parse as PARSE
from port_fixtures import bench_frame, sharp_frame, waves_frame

CPU = torch.device("cpu")


# name: (encoder, image, distance, progressive)
TWIN_STREAMS = {
    "port 96x288 d1.0": ("port", (96, 288), 1.0, False),
    "port 300x520 d1.0": ("port", (300, 520), 1.0, False),
    # dense tokens, and a single section
    "jax 128x128 d0.1": ("jax", (128, 128), 0.1, False),
    "jax 200x232 d1.0 two passes": ("jax", (200, 232), 1.0, True),
    "port 80x112 d1.0 single section": ("port", (80, 112), 1.0, False),
}
# only for the g++ build of the kernel's step: ~10-60k tokens a group
DENSE_STREAMS = {
    "port 96x288 d1.0 noisy": ("port", (96, 288), 1.0, False),
    "port 256x384 sharp d0.1": ("port", (256, 384), 0.1, False),
    "jax 200x232 noisy two passes": ("jax", (200, 232), 1.0, True),
}


@functools.lru_cache(maxsize=None)
def _stream(name: str) -> bytes:
    enc, (h, w), d, prog = {**TWIN_STREAMS, **DENSE_STREAMS}[name]
    img = (waves_frame if name in TWIN_STREAMS else
           sharp_frame if "sharp" in name else bench_frame)(h, w)
    encode = reference.encode_vardct if enc == "port" else jax_encode
    return encode(img, distance=d, effort=7, progressive=prog)


def _host_blocks(data: bytes):
    return PARSE.parse_frame(*api._read_frame(data))["blocks_glob"]


def _within(got, ref):
    """The decode contract at 8 bits (tests/test_torch_decode.py)."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def _spy_port(monkeypatch) -> dict:
    """Record what the port's device route packs and decodes."""
    seen = {}
    tables, check = ENT.frame_tables, ENT.check_groups

    def frame_tables(cs, anchors, streams, hf, *args):
        seen.update(anchors=anchors, hf=hf)
        seen["tables"] = tables(cs, anchors, streams, hf, *args)
        return seen["tables"]

    def check_groups(decoded):
        seen["decoded"] = decoded
        return check(decoded)

    monkeypatch.setattr(ENT, "frame_tables", frame_tables)
    monkeypatch.setattr(ENT, "check_groups", check_groups)
    return seen


def _bits_from(data: bytes, bit: int) -> bytes:
    """data's bits from `bit` on, as bytes (a stream that starts mid-byte
    made byte-aligned for the reference's GroupInput)."""
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    return np.packbits(bits[bit:], bitorder="little").tobytes()


def _jax_reference(data: bytes, monkeypatch):
    """The JAX package's device entropy decode of every pass group its own
    host decode reads (as dec_real._entropy_device_pass_groups runs it,
    single-section frames included): per pass its pack_code, per group
    build_group_schedule, then decode_pass_groups_device on CPU JAX,
    unpack_to_blockarrays, the passes accumulated with their shifts and
    the groups concatenated.  -> (packs, {gi: schedule}, BlockArrays)."""
    cs, hdr, fh, toc = api._read_frame(data)
    sections = {bytes(cs[s.offset:s.offset + s.size]): i
                for i, s in enumerate(toc.entries)}
    calls = []
    read = REF_DR.read_pass_group

    def read_pass_group(br, lf, hf, lg, xs_b, ys_b, p, histo, dc_q, *a, **k):
        calls.append((bytes(br.data), br.pos, lf, hf, lg, xs_b, ys_b, p,
                      dc_q))
        return read(br, lf, hf, lg, xs_b, ys_b, p, histo, dc_q, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(REF_DR, "read_pass_group", read_pass_group)
        m.setenv("JXL_TPU_ENTROPY", "0")
        m.setenv("JXL_TPU_DEVICE", "0")
        ref_api.decode(data)
    ng, ndc = fh.counts(hdr)
    hf, lf = calls[0][3], calls[0][2]
    num_ctxs = lf.bcm.num_ctxs
    hb = (hf.num_histograms - 1).bit_length() if hf.num_histograms > 1 else 0
    gx = -(-fh.coded_size(hdr)[0] // 256)      # AC groups per row
    by_pass = {}
    scheds = {}
    for sec, pos, lf_, hf_, lg, xs_b, ys_b, p, dc_q in calls:
        idx = sections[sec] if len(toc.entries) > 1 else 2 + ndc
        gi = (idx - 2 - ndc) % ng
        scheds[gi] = REF.build_group_schedule(lf_, lg, xs_b, ys_b, dc_q, hf_)
        by_pass.setdefault(p, {})[gi] = _bits_from(sec, pos - hb)
    packs = [REF.pack_code(hf.accodes[p]) for p in sorted(by_pass)]
    shift = list(fh.passes.shift) + [0]
    blocks = {}
    for p in sorted(by_pass):
        gis = sorted(by_pass[p])
        gins = [REF.GroupInput(by_pass[p][gi], hb, num_ctxs, scheds[gi])
                for gi in gis]
        out, ok = REF.decode_pass_groups_device(packs[p], gins, num_ctxs)
        assert ok.all()
        for row, gi in enumerate(gis):
            ba = REF.unpack_to_blockarrays(out[row], scheds[gi], hf, p)
            if gi not in blocks:
                blocks[gi] = ba
                ba.coeffs = ba.coeffs.astype(np.int64) << shift[0]
            else:
                blocks[gi].accumulate_pass(ba, shift[p])
    parts = [((gi % gx) * 32, (gi // gx) * 32, blocks[gi])
             for gi in sorted(blocks)]
    return packs, scheds, REF_DR.BlockArrays.concat(parts)


@pytest.mark.parametrize("name", list(TWIN_STREAMS))
def test_device_route_equals_the_jax_decode_and_the_host(name, monkeypatch):
    """api.decode(data, "cpu", entropy="device") runs the twin once; its
    tables and anchors are the JAX package's, its coefficients equal the
    JAX device decode's and the host route's bit for bit, its pixels the
    host route's, and within the decode contract of JAX's api.decode
    under JXL_TPU_ENTROPY=1."""
    data = _stream(name)
    seen = _spy_port(monkeypatch)
    got, info = api.decode(data, "cpu", entropy="device")
    assert np.array_equal(got, api.decode(data, "cpu")[0])

    dec, anchors, hf = seen["decoded"], seen["anchors"], seen["hf"]
    assert not dec.status.any()
    assert bool((dec.states == ENT.SIGNATURE_STATE).all())
    host = _host_blocks(data)
    for f in ("ids", "bxs", "bys", "ncv", "offs"):
        assert np.array_equal(getattr(anchors, f), getattr(host, f))
    coeffs = dec.coeffs.numpy().astype(np.int64)
    assert np.array_equal(coeffs, host.coeffs.astype(np.int64))

    packs, scheds, jax_blocks = _jax_reference(data, monkeypatch)
    assert np.array_equal(coeffs, jax_blocks.coeffs.astype(np.int64))
    assert np.array_equal(anchors.offs, jax_blocks.offs)
    for p, jp in enumerate(packs):
        pk = ENT.pack_code(hf.accodes[p])
        assert np.array_equal(pk["cluster_map"], jp["cluster_map"])
        for mine, ref in zip(ENT.lookup_tables(pk),
                             (jp["sym"], jp["off"], jp["freq"])):
            assert np.array_equal(mine, ref)
        cfg = pk["configs"].astype(np.int64)
        assert np.array_equal(cfg & 0xFF, jp["cfg_se"])
        assert np.array_equal((cfg >> 8) & 0xFF, jp["cfg_msb"])
        assert np.array_equal(cfg >> 16, jp["cfg_lsb"])
    table, gs = anchors.table.T, anchors.group_start
    assert len(scheds) == len(gs) - 1
    for gi, s in scheds.items():
        rows = table[gs[gi]:gs[gi + 1]]
        assert len(rows) == s["nblk"]
        assert np.array_equal(rows[:, [1, 0]], s["pos"])
        assert np.array_equal(rows[:, 4], s["size"])
        assert np.array_equal(rows[:, 2], s["cov"])
        assert np.array_equal(rows[:, 3], s["l2c"])
        assert np.array_equal(anchors.ids[gs[gi]:gs[gi + 1]], s["sid"])
        # the reference keeps block contexts in decode order (y, x, b)
        assert np.array_equal(rows[:, [9, 8, 10]], s["bctx"])

    monkeypatch.setenv("JXL_TPU_ENTROPY", "1")
    monkeypatch.setenv("JXL_TPU_ENTROPY_STRICT", "1")
    _within(got, ref_api.decode(data)[0])


_STEP_RUN = r"""
#include <vector>
#include "entropy.cuh"
using namespace jxl_entropy;
// entropy.cu's groups_kernel with one group after another on the host
extern "C" void decode_groups(
    const uint32_t* words, long long nwords, const int32_t* anchors,
    const int64_t* offs, const int32_t* group_start, const int64_t* streams,
    const int32_t* passes, const uint32_t* alias, const uint32_t* configs,
    const uint8_t* cmap, const int32_t* orders, const int32_t* order_off,
    const uint16_t* ctx_tabs, int num_ctxs, int num_passes, int num_groups,
    int32_t* out, int32_t* status, uint32_t* states, int64_t* tokens) {
  for (int g = 0; g < num_groups; g++) {
    const int first = group_start[g], n = group_start[g + 1] - first;
    int s = 0;
    int64_t tok = 0;
    for (int p = 0; p < num_passes && !s; p++) {
      const int32_t* pp = passes + p * 7;
      const int64_t* st = streams + ((int64_t)p * num_groups + g) * 3;
      std::vector<uint8_t> nz(3 * kGroupBlocks * kGroupBlocks, 0);
      PassTables t;
      t.cmap = cmap + pp[3] + st[2];
      t.alias = alias + pp[1];
      t.configs = configs + pp[2];
      t.orders = orders;
      t.order_off = order_off + p * kOrderBuckets * 3;
      t.nz_ctx = ctx_tabs;
      t.freq_ctx = ctx_tabs + 64;
      t.log_alpha = pp[0];
      t.num_ctxs = num_ctxs;
      t.shift = pp[4];
      t.add = p > 0;
      Bits b;
      bits_init(b, words, nwords, st[0], st[1]);
      uint32_t state = bits_read(b, 32, s);
      if (!(s & kStop))
        s |= decode_group_pass(anchors + first, group_start[num_groups], n,
                               offs + first, t, b, state, nz.data(), out, tok);
      states[(int64_t)p * num_groups + g] = state;
    }
    status[g] = s;
    tokens[g] = tok;
  }
}
"""


@pytest.fixture(scope="module")
def step_decode(tmp_path_factory):
    """csrc/entropy.cuh's token step built for the host with g++, behind
    decode_pass_groups' signature (Tables -> Decoded)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's host codec; it is needed here too"
    tmp = tmp_path_factory.mktemp("entropy")
    cpp, so = tmp / "run.cpp", tmp / "librun.so"
    cpp.write_text(_STEP_RUN)
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", str(_build.CSRC), "-o", str(so),
                    str(cpp)], check=True)
    fn = ctypes.CDLL(str(so)).decode_groups
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 4)

    def decode(t: ENT.Tables) -> ENT.Decoded:
        G, P = t.group_start.numel() - 1, t.passes.shape[0]
        out = torch.zeros(max(t.total, 1), dtype=torch.int32)
        status = torch.zeros(G, dtype=torch.int32)
        states = torch.zeros((P, G), dtype=torch.int32)
        tokens = torch.zeros(G, dtype=torch.int64)
        fn(t.words.data_ptr(), t.words.numel(),
           *[x.data_ptr() for x in (t.anchors, t.offs, t.group_start,
                                    t.streams, t.passes, t.alias, t.configs,
                                    t.cmap, t.orders, t.order_off,
                                    t.ctx_tabs)],
           t.num_ctxs, P, G,
           *[x.data_ptr() for x in (out, status, states, tokens)])
        return ENT.Decoded(out[:t.total], status, states.long() & 0xFFFFFFFF,
                           tokens)
    return decode


@pytest.mark.parametrize("name", list(TWIN_STREAMS) + list(DENSE_STREAMS))
def test_kernel_step_decodes_like_the_host(name, step_decode, monkeypatch):
    """The device route with the kernel's own token step (built with g++)
    in place of the launch gives the host route's coefficients, with every
    group's status 0 and final rANS state the signature."""
    data = _stream(name)
    seen = _spy_port(monkeypatch)
    monkeypatch.setattr(ENT, "decode_pass_groups", step_decode)
    cs, hdr, fh, toc = api._read_frame(data)
    blocks = PARSE.parse_frame(cs, hdr, fh, toc, entropy="device",
                               device=CPU)["blocks_glob"]
    assert np.array_equal(blocks.coeffs.numpy().astype(np.int64),
                          _host_blocks(data).coeffs.astype(np.int64))
    assert int(seen["decoded"].tokens.max()) > 0


def _corrupt(data: bytes, where: float) -> bytes:
    """data with one byte flipped at `where` of the first pass group's
    section."""
    cs, hdr, fh, toc = api._read_frame(data)
    ng, ndc = fh.counts(hdr)
    s = toc.section(2 + ndc) if len(toc.entries) > 1 else toc.section(0)
    pos = len(data) - len(cs) + s.offset + int(where * (s.size - 1))
    bad = bytearray(data)
    bad[pos] ^= 0x5A
    return bytes(bad)


@pytest.mark.parametrize("where", [0.0, 0.3, 0.6])
def test_a_corrupt_group_raises_and_the_twin_agrees_with_the_kernel_step(
        where, step_decode, monkeypatch):
    """One byte flipped inside a pass group: entropy="device" raises
    InvalidJXLError naming the group, and the twin and the kernel's token
    step (g++) leave the same coefficients, status bits, final states and
    token counts."""
    data = _corrupt(_stream("port 96x288 d1.0"), where)
    seen = _spy_port(monkeypatch)
    with pytest.raises(InvalidJXLError, match="groups \\[0"):
        api.decode(data, "cpu", entropy="device")
    twin, step = seen["decoded"], step_decode(seen["tables"])
    assert twin.status[0] != 0 or int(twin.states[0, 0]) != \
        ENT.SIGNATURE_STATE
    for a, b in zip(twin, step):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["prefix", "lz77"])
def test_prefix_and_lz77_codes_raise(backend, monkeypatch):
    """The device decode reads ANS without LZ77; a pass's code with prefix
    codes or LZ77 raises NotImplementedError naming it (the reference
    sends such a frame back to the host instead)."""
    read = PARSE.read_hf_global

    def read_hf_global(*a, **k):
        hf = read(*a, **k)
        code = hf.accodes[0]
        if backend == "prefix":
            code.use_prefix = True
        else:
            code.lz77 = types.SimpleNamespace(enabled=True)
        return hf

    monkeypatch.setattr(PARSE, "read_hf_global", read_hf_global)
    with pytest.raises(NotImplementedError,
                       match="prefix codes" if backend == "prefix" else
                       "LZ77"):
        api.decode(_stream("port 80x112 d1.0 single section"), "cpu",
                   entropy="device")


@pytest.mark.parametrize("call", ["decode", "prepare", "parse_frame"])
def test_an_unknown_entropy_route_raises(call):
    data = _stream("port 80x112 d1.0 single section")
    with pytest.raises(ValueError, match="bogus"):
        if call == "parse_frame":
            PARSE.parse_frame(*api._read_frame(data), entropy="bogus")
        else:
            getattr(api, call)(data, "cpu", entropy="bogus")
