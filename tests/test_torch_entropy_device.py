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
// entropy.cu's groups_kernel with one group after another on the host: the
// chain's records go through a ring of `ring` slots (a power of two); the
// chain's loop stops when it is full (open() false), room() drains it,
// and the pass's end drains the rest, as the scatter warp drains the
// kernel's
struct HostRing {
  std::vector<uint32_t> rec;   // where, lo, hi a slot
  uint32_t mask, head = 0, tail = 0;
  const Scatter* s;
  int over = 0;
  void drain() {
    for (; tail != head; ++tail) {
      const uint32_t* e = &rec[3 * (tail & mask)];
      over |= apply_record(*s, e[0], e[1], e[2]);
    }
  }
  bool open() const { return head - tail <= mask; }
  void room() { drain(); }
  void put(bool keep, uint32_t where, uint32_t lo, uint32_t hi) {
    if (!keep) return;
    uint32_t* e = &rec[3 * (head & mask)];
    e[0] = where;
    e[1] = lo;
    e[2] = hi;
    ++head;
  }
};

extern "C" void decode_groups(
    const uint32_t* words, long long nwords, const int32_t* anchors,
    const int64_t* offs, const int32_t* group_start, const int64_t* streams,
    const int32_t* passes, const uint32_t* alias, const uint32_t* configs,
    const uint8_t* cmap, const int32_t* orders, const int32_t* order_off,
    const uint16_t* ctx_tabs, int num_ctxs, int num_passes, int num_groups,
    int ring, int32_t* out, int32_t* status, uint32_t* states,
    int64_t* tokens) {
  for (int g = 0; g < num_groups; g++) {
    const int first = group_start[g], n = group_start[g + 1] - first;
    std::vector<uint32_t> packed(n);
    for (int i = 0; i < n; i++)
      packed[i] = pack_anchor(anchors + first + i, group_start[num_groups]);
    int s = n > kGroupBlocks * kGroupBlocks ? kErrIndex : 0;
    uint32_t tok = 0;
    for (int p = 0; p < num_passes && !s; p++) {
      const int32_t* pp = passes + p * 7;
      const int64_t* st = streams + ((int64_t)p * num_groups + g) * 3;
      std::vector<uint8_t> nz(3 * kGroupBlocks * kGroupBlocks, 0);
      PassTables t;
      t.cmap = cmap + pp[3] + st[2];
      t.alias = alias + pp[1];
      t.configs = configs + pp[2];
      t.nz_ctx = ctx_tabs;
      t.freq_ctx = ctx_tabs + 64;
      t.log_alpha = pp[0];
      t.num_ctxs = num_ctxs;
      Scatter sc;
      sc.out = out;
      sc.offs = offs + first;
      sc.anchors = packed.data();
      sc.orders = orders;
      sc.order_off = order_off + p * kOrderBuckets * 3;
      sc.shift = pp[4];
      sc.add = p > 0;
      HostRing r;
      r.rec.resize(3 * ring);
      r.mask = ring - 1;
      r.s = &sc;
      Bits b;
      bits_init(b, words, nwords, st[0], st[1]);
      uint32_t state = bits_read(b, 32, s);
      if (!(s & kStop))
        s |= decode_group_pass(packed.data(), n, t, b, state, nz.data(), r,
                               tok);
      r.drain();
      s |= r.over ? kErrOverflow : 0;
      states[(int64_t)p * num_groups + g] = state;
    }
    status[g] = s;
    tokens[g] = tok;
  }
}
"""


@pytest.fixture(scope="module")
def step_decode(tmp_path_factory):
    """csrc/entropy.cuh's token chain and scatter built for the host with
    g++, behind decode_pass_groups' signature (Tables -> Decoded; `ring`:
    the records' ring, the kernel's 512 slots by default)."""
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
                   + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 4)

    def decode(t: ENT.Tables, ring: int = 512) -> ENT.Decoded:
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
           t.num_ctxs, P, G, ring,
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


@pytest.mark.parametrize("name", ["jax 128x128 d0.1",
                                  "jax 200x232 d1.0 two passes",
                                  "port 256x384 sharp d0.1",
                                  "jax 200x232 noisy two passes"])
def test_kernel_split_decodes_like_the_host_through_a_ring_that_wraps(
        name, step_decode, monkeypatch):
    """The chain and the scatter (g++) with a ring of 4 records, fewer
    than one varblock's coefficients: the ring wraps inside every dense
    varblock and the chain waits on the scatter, and the coefficients are
    still the host route's, with the status, final states and tokens of
    the kernel's own ring size."""
    data = _stream(name)
    seen = _spy_port(monkeypatch)
    monkeypatch.setattr(ENT, "decode_pass_groups",
                        functools.partial(step_decode, ring=4))
    cs, hdr, fh, toc = api._read_frame(data)
    blocks = PARSE.parse_frame(cs, hdr, fh, toc, entropy="device",
                               device=CPU)["blocks_glob"]
    assert np.array_equal(blocks.coeffs.numpy().astype(np.int64),
                          _host_blocks(data).coeffs.astype(np.int64))
    for x, y in zip(seen["decoded"], step_decode(seen["tables"])):
        assert torch.equal(x, y)
    # nonzeros per varblock channel well past the ring
    assert int((blocks.coeffs != 0).sum()) > 4 * len(seen["tables"].offs)


_ASAN_MAIN = r"""
#include <cstdio>
#include <fstream>
#include <string>
template <class T>
static std::vector<T> load(const std::string& dir, const char* name) {
  std::ifstream in(dir + "/" + name, std::ios::binary | std::ios::ate);
  const size_t n = in.tellg();
  std::vector<T> v(n / sizeof(T));   // exactly the array: nothing around it
  in.seekg(0);
  in.read(reinterpret_cast<char*>(v.data()), n);
  return v;
}
int main(int argc, char** argv) {
  const std::string d = argv[1];
  const int num_ctxs = atoi(argv[2]), P = atoi(argv[3]), G = atoi(argv[4]);
  const long long total = atoll(argv[5]);
  auto words = load<uint32_t>(d, "words");
  auto anchors = load<int32_t>(d, "anchors");
  auto offs = load<int64_t>(d, "offs");
  auto gs = load<int32_t>(d, "group_start");
  auto streams = load<int64_t>(d, "streams");
  auto passes = load<int32_t>(d, "passes");
  auto alias = load<uint32_t>(d, "alias");
  auto configs = load<uint32_t>(d, "configs");
  auto cmap = load<uint8_t>(d, "cmap");
  auto orders = load<int32_t>(d, "orders");
  auto order_off = load<int32_t>(d, "order_off");
  auto ctx = load<uint16_t>(d, "ctx_tabs");
  for (int ring : {4, 512}) {
    std::vector<int32_t> out(total), status(G);
    std::vector<uint32_t> states(P * G);
    std::vector<int64_t> tokens(G);
    decode_groups(words.data(), (long long)words.size(), anchors.data(),
                  offs.data(), gs.data(), streams.data(), passes.data(),
                  alias.data(), configs.data(), cmap.data(), orders.data(),
                  order_off.data(), ctx.data(), num_ctxs, P, G, ring,
                  out.data(), status.data(), states.data(), tokens.data());
    std::ofstream(d + "/out" + std::to_string(ring), std::ios::binary)
        .write(reinterpret_cast<const char*>(out.data()), total * 4);
  }
  return 0;
}
"""


@pytest.mark.parametrize("name", list(DENSE_STREAMS))
def test_kernel_chain_reads_and_writes_stay_inside_its_tables(
        name, step_decode, tmp_path, monkeypatch):
    """The chain and the scatter built with g++ as a program under
    AddressSanitizer and UBSan, each table in a buffer of exactly its size:
    no access outside them (the nonzero-count context of a channel
    without nonzeros, kCoeffNumNonzeroCtx[0], is a sentinel past the
    zero-density contexts), and the host route's coefficients, with the
    kernel's ring and with one that wraps."""
    seen = _spy_port(monkeypatch)
    monkeypatch.setattr(ENT, "decode_pass_groups", step_decode)
    data = _stream(name)
    PARSE.parse_frame(*api._read_frame(data), entropy="device", device=CPU)
    t = seen["tables"]
    for field in ("words", "anchors", "offs", "group_start", "streams",
                  "passes", "alias", "configs", "cmap", "orders",
                  "order_off", "ctx_tabs"):
        getattr(t, field).numpy().tofile(tmp_path / field)
    src = _STEP_RUN.replace('extern "C" void decode_groups',
                            "void decode_groups") + _ASAN_MAIN
    (tmp_path / "run.cpp").write_text(src)
    exe = tmp_path / "run"
    subprocess.run([shutil.which("g++"), "-O1", "-g", "-std=c++17",
                    "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=all", "-I", str(_build.CSRC),
                    "-o", str(exe), str(tmp_path / "run.cpp")], check=True)
    G, P = t.group_start.numel() - 1, t.passes.shape[0]
    run = subprocess.run([str(exe), str(tmp_path), str(t.num_ctxs), str(P),
                          str(G), str(t.total)], capture_output=True,
                         text=True, env={"ASAN_OPTIONS": "detect_leaks=0"})
    assert run.returncode == 0, run.stderr[-3000:]
    host = _host_blocks(data).coeffs.astype(np.int64)
    for ring in (4, 512):
        got = np.fromfile(tmp_path / f"out{ring}", np.int32)
        assert np.array_equal(got.astype(np.int64), host)


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
