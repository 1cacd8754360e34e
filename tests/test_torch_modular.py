"""The port's Modular decode on the CPU against the JAX package.

- The plain twins of the three kernels of ``csrc/modular.cu``
  (``modular/device.py``: unsqueeze, rct_inverse, palette_inverse)
  against the JAX package's int64 host oracle
  (``jxl_coder_tpu/modular/transform.py``), exactly, R1's range
  included, where the JAX device path's int32 SmoothTendency wraps.
- ``undo_transforms`` on planes uploaded to the CPU against the host
  chain.
- ``api.decode(data, device="cpu")`` against ``jxl_coder_tpu.api.decode``
  bit for bit on the JAX package's lossless streams and on the port's
  fixture streams (squeezed, group-local RCT; XYB within 1 code on
  under 0.1% of pixels).
- What must raise, and the fixture writer's bytes.
Integer paths throughout: every comparison is exact unless it says so.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from jxl_coder_tpu import api as ref_api
from jxl_coder_tpu import codec as ref_codec
from jxl_coder_tpu.bitstream import frame_header as ref_fhm
from jxl_coder_tpu.bitstream import headers as ref_hm
from jxl_coder_tpu.bitstream.writer import BitWriter as RefBitWriter
from jxl_coder_tpu.modular import device as ref_device
from jxl_coder_tpu.modular import transform as RT
from jxl_coder_tpu.modular.image import Channel as RefChannel
from jxl_coder_tpu.modular.image import ModularImage as RefImage
from jxl_coder_tpu_torch import api, reference
from jxl_coder_tpu_torch.host.bitstream.writer import BitWriter
from jxl_coder_tpu_torch.host.modular import transform as PT
from jxl_coder_tpu_torch.host.modular.image import Channel, ModularImage
from jxl_coder_tpu_torch.host.modular.stream import GroupHeader
from jxl_coder_tpu_torch.modular import device as MDEV
import port_fixtures as F


@pytest.fixture(autouse=True)
def _host_oracle(monkeypatch):
    """The JAX package's Modular inverse transforms on its host loop."""
    monkeypatch.delenv("JXL_TPU_MODULAR_DEVICE", raising=False)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


# ---- (a) each twin against the int64 host oracle ----

def _host_unsqueeze(avg, res, horizontal):
    if horizontal:
        return RT._unsqueeze_1d(avg, res, avg.shape[1] + res.shape[1]
                                ).astype(np.int32)
    return RT._unsqueeze_1d(avg.T, res.T, avg.shape[0] + res.shape[0]
                            ).T.astype(np.int32)


def _squeeze_pair(rng, lines, n, horizontal, scale=3000):
    """avg / res of a seeded plane squeezed along its axis (the
    tendencies of real data), the plane `lines` x n along the axis."""
    line_major = rng.integers(-scale, scale, (lines, n))
    line_major = np.cumsum(line_major, axis=1) // 4     # smooth-ish rows
    avg, res = RT._squeeze_1d(line_major)
    if horizontal:
        return avg.astype(np.int32), res.astype(np.int32)
    return avg.T.astype(np.int32).copy(), res.T.astype(np.int32).copy()


@pytest.mark.parametrize("horizontal", [True, False])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 64, 65, 130, 131])
def test_unsqueeze_twin_equals_the_host_oracle(horizontal, n):
    rng = np.random.default_rng(n)
    avg, res = _squeeze_pair(rng, 5, n, horizontal)
    ax = 1 if horizontal else 0
    assert res.shape[ax] == n // 2 and avg.shape[ax] == (n + 1) // 2
    got = MDEV.unsqueeze(_t(avg), _t(res), horizontal)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _host_unsqueeze(avg, res, horizontal))


@pytest.mark.parametrize("horizontal", [True, False])
def test_unsqueeze_twin_on_random_residuals(horizontal):
    """Seeded averages and residuals that no forward squeeze gave, nr < na
    (an odd length) and nr == na, on a strided view."""
    rng = np.random.default_rng(3)
    for na, nr in ((9, 8), (9, 9), (1, 0), (1, 1)):
        shape_a = (6, na) if horizontal else (na, 6)
        shape_r = (6, nr) if horizontal else (nr, 6)
        avg = rng.integers(-500, 500, shape_a).astype(np.int32)
        res = rng.integers(-500, 500, shape_r).astype(np.int32)
        wide = torch.zeros((shape_a[0], shape_a[1] + 3), dtype=torch.int32)
        wide[:, 1:1 + shape_a[1]] = _t(avg)
        got = MDEV.unsqueeze(wide[:, 1:1 + shape_a[1]], _t(res), horizontal)
        assert np.array_equal(got.numpy(),
                              _host_unsqueeze(avg, res, horizontal))


@pytest.mark.parametrize("rct_type", range(42))
def test_rct_twin_equals_the_host_oracle(rct_type):
    rng = np.random.default_rng(rct_type)
    planes = [rng.integers(-70000, 70000, (7, 9)).astype(np.int32)
              for _ in range(3)]
    # int32 extremes: the int64 sums cut to int32 as astype(np.int32) does
    for p in planes:
        p[0, :3] = (2**31 - 1, -2**31, 2**31 - 2)
    img = RefImage([RefChannel(9, 7, data=p.copy()) for p in planes])
    RT.rct_inverse(img, RT.Transform(id=0, begin_c=0, rct_type=rct_type))
    got = MDEV.rct_inverse(*map(_t, planes), rct_type)
    assert got.shape == (3, 7, 9)
    for i in range(3):
        assert np.array_equal(got[i].numpy(), img.channels[i].data)


@pytest.mark.parametrize("num_c,nb", [(1, 5), (3, 17), (4, 1), (3, 256)])
def test_palette_twin_equals_the_host_oracle(num_c, nb):
    """Negative, in-range and over-range indices (fault R2: an index >=
    nb gives index - nb, a negative one 0)."""
    rng = np.random.default_rng(nb)
    pal = rng.integers(-1000, 66000, (num_c, nb)).astype(np.int32)
    idx = rng.integers(-4, nb + 40, (11, 13)).astype(np.int32)
    other = rng.integers(0, 9, (11, 13)).astype(np.int32)
    img = RefImage([RefChannel(nb, num_c, -1, -1, pal.copy()),
                    RefChannel(13, 11, data=other.copy()),
                    RefChannel(13, 11, data=idx.copy())], nb_meta_channels=1)
    RT.palette_inverse(img, RT.Transform(id=1, begin_c=1, num_c=num_c,
                                         nb_colours=nb))
    got = MDEV.palette_inverse(_t(pal), _t(idx), num_c, nb)
    assert got.shape == (num_c, 11, 13)
    for c in range(num_c):
        assert np.array_equal(got[c].numpy(), img.channels[1 + c].data)


# ---- (b) R1: the JAX device path wraps where the host oracle does not ----

def test_unsqueeze_near_2_29_equals_the_host_oracle_not_the_jax_device():
    rng = np.random.default_rng(29)
    base = 1 << 29
    # +-2^29 in pairs: 4a - 3c - b of a falling triple leaves int32
    lines = (np.where(np.arange(40) % 4 < 2, base, -base)
             + rng.integers(-1000, 1000, (4, 40)))
    avg, res = RT._squeeze_1d(lines)
    avg, res = avg.astype(np.int32), res.astype(np.int32)
    host = _host_unsqueeze(avg, res, True)
    assert np.array_equal(host, lines)          # the oracle round-trips
    got = MDEV.unsqueeze(_t(avg), _t(res), True)
    assert np.array_equal(got.numpy(), host)
    import jax.numpy as jnp
    jax_dev = np.asarray(ref_device._unsqueeze_1d_jnp(
        jnp.asarray(avg), jnp.asarray(res), 40))
    assert not np.array_equal(jax_dev, host)    # fault R1 shows


# ---- (c) the port's undo_transforms against the host chain ----

def _both_images(channels, nb_meta=0):
    """The same decoder-side image in both packages."""
    ref = RefImage([RefChannel(c.width, c.height, c.hshift, c.vshift,
                               c.data.copy()) for c in channels], nb_meta)
    port = ModularImage([Channel(c.width, c.height, c.hshift, c.vshift,
                                 c.data.copy()) for c in channels], nb_meta)
    return ref, port


def _host_chain(image, transforms):
    for t in reversed(transforms):
        {0: RT.rct_inverse, 1: RT.palette_inverse,
         2: RT.squeeze_inverse}[t.id](image, t)


def _port_transforms(transforms):
    return [PT.Transform(**{k: v for k, v in dataclasses.asdict(t).items()
                            if k != "squeezes"},
                         squeezes=[PT.SqueezeParams(**dataclasses.asdict(s))
                                   for s in t.squeezes])
            for t in transforms]


def _check_chain(chans, nb_meta, transforms):
    ref, port = _both_images(chans, nb_meta)
    _host_chain(ref, copy.deepcopy(transforms))
    MDEV.upload(port, "cpu")
    MDEV.undo_transforms(port,
                         GroupHeader(transforms=_port_transforms(transforms)))
    assert port.nb_meta_channels == ref.nb_meta_channels
    assert len(port.channels) == len(ref.channels)
    for a, b in zip(port.channels, ref.channels):
        assert isinstance(a.data, torch.Tensor)
        assert (a.width, a.height, a.hshift, a.vshift) == \
            (b.width, b.height, b.hshift, b.vshift)
        assert np.array_equal(a.data.numpy(), b.data)


def test_undo_transforms_squeeze_and_rct_equals_the_host_chain():
    """tests/test_modular.py's construction: default squeeze + RCT 6."""
    rng = np.random.default_rng(11)
    w, h = 97, 65
    img = RefImage([RefChannel(w, h, data=rng.integers(
        -3000, 3000, (h, w)).astype(np.int32)) for _ in range(3)])
    rct = RT.Transform(id=0, begin_c=0, rct_type=6)
    sq = RT.Transform(id=2, squeezes=RT.default_squeeze_params(img))
    RT.rct_forward(img, rct)
    RT.squeeze_forward(img, sq)
    _check_chain(img.channels, 0, [rct, sq])


def test_undo_transforms_palette_then_squeeze_equals_the_host_chain():
    """A palette under a squeeze: the meta channel and the index plane's
    squeezed halves, on a grey + alpha pair of channels."""
    rng = np.random.default_rng(12)
    w, h = 41, 23
    colours = rng.integers(0, 255, (3, 6))
    pick = rng.integers(0, 6, (h, w))
    img = RefImage([RefChannel(w, h, data=colours[c][pick].astype(np.int32))
                    for c in range(3)]
                   + [RefChannel(w, h, data=rng.integers(0, 255, (h, w))
                                 .astype(np.int32))])
    pal = RT.Transform(id=1, begin_c=0, num_c=3, nb_colours=6)
    RT.palette_forward(img, pal)
    sq = RT.Transform(id=2, squeezes=RT.default_squeeze_params(img))
    RT.squeeze_forward(img, sq)
    _check_chain(img.channels, img.nb_meta_channels, [pal, sq])


# ---- (d) api.decode against jxl_coder_tpu.api.decode ----

def _rgb(h, w, seed=5):
    return F.smooth_frame(h, w, seed)


def _count_twin(monkeypatch, name):
    calls = []
    plain = getattr(MDEV, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(MDEV, name, counted)
    return calls


def _same_as_jax(data, monkeypatch=None, twin=None):
    calls = _count_twin(monkeypatch, twin) if twin else None
    got, info = api.decode(data, device="cpu")
    ref, ref_info = ref_api.decode(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)
    assert dataclasses.asdict(info) == dataclasses.asdict(ref_info)
    if twin:
        assert calls, f"{twin} did not run"
    return got


@pytest.mark.parametrize("effort", [1, 2, 5])
def test_decode_rgb_equals_jax(effort):
    img = _rgb(37, 53)
    got = _same_as_jax(ref_api.encode(img, lossless=True, effort=effort))
    assert np.array_equal(got, img)


@pytest.mark.parametrize("kind", ["grey", "rgba", "16bit"])
def test_decode_channels_and_depths_equal_jax(kind):
    img = _rgb(29, 43)
    if kind == "grey":
        img = img[:, :, :1]
    elif kind == "rgba":
        img = np.concatenate([img, img[:, :, 1:2] // 2 + 7], -1)
    else:
        img = img.astype(np.uint16) * 257 + 3
    got = _same_as_jax(ref_api.encode(img, lossless=True, effort=2))
    assert got.shape == img.shape and np.array_equal(got, img)


def test_decode_palette_body_equals_jax(monkeypatch):
    img = F.posterized_frame(32, 48, levels=3)
    data = ref_api.encode(img, lossless=True, effort=2)
    got = _same_as_jax(data, monkeypatch, "palette_inverse_plain")
    assert np.array_equal(got, img)


def test_decode_two_groups_equals_jax():
    img = _rgb(19, 1030, seed=9)
    got = _same_as_jax(ref_api.encode(img, lossless=True, effort=2))
    assert np.array_equal(got, img)


# ---- (e) the port's fixture streams ----

@pytest.mark.parametrize("kind", ["squeezed", "group_rct", "palette_4groups",
                                  "rgba16_rct"])
def test_decode_fixture_streams_equal_jax(kind, monkeypatch):
    if kind == "rgba16_rct":
        img = F.bench_frame(33, 47).astype(np.uint16) * 257
        img = np.concatenate([img, img[:, :, :1] // 3], -1)
        data, twin = F.modular_still(img), "rct_inverse_plain"
    elif kind == "squeezed":
        img = F.bench_frame(45, 67)
        data, twin = F.squeezed_still(img), "unsqueeze_plain"
    elif kind == "group_rct":
        img = F.bench_frame(140, 270)
        data, twin = F.group_rct_still(img), "rct_inverse_plain"
    else:
        img = F.posterized_frame(140, 150)
        data = F.modular_still(img, palette=True, group_shift=0)
        twin = "palette_inverse_plain"
    got = _same_as_jax(data, monkeypatch, twin)
    assert np.array_equal(got, img)


def test_decode_xyb_within_one_code_of_jax(monkeypatch):
    img = F.bench_frame(48, 61)
    data = F.xyb_still(img)
    calls = _count_twin(monkeypatch, "unsqueeze_plain")
    got, _ = api.decode(data, device="cpu")
    ref, _ = ref_api.decode(data)
    assert calls and got.dtype == ref.dtype == np.uint8
    assert got.shape == ref.shape == img.shape
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    assert np.abs(got.astype(int) - img.astype(int)).mean() < 2


def test_xyb_output_is_kernel_2s_output_step(monkeypatch):
    """The XYB -> sRGB step goes through restore_and_output with every
    filter off (one chain_kernel launch on the card), on the cropped
    frame, and its plain twin gives the pixels here."""
    from jxl_coder_tpu_torch.vardct import filters
    entry, calls = filters.restore_and_output, []

    def recorded(x, sigma, gab, epf_iters, *rest):
        calls.append((tuple(x.shape), sigma, gab, epf_iters, rest[-1]))
        return entry(x, sigma, gab, epf_iters, *rest)

    monkeypatch.setattr(filters, "restore_and_output", recorded)
    img = F.bench_frame(21, 35)
    got, _ = api.decode(F.xyb_still(img), device="cpu")
    assert calls == [((3, 21, 35), None, False, 0, "u8")]
    ref, _ = ref_api.decode(F.xyb_still(img))
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


# ---- (f) what must raise ----

def test_modular_outside_the_slice_raises():
    """entropy="device" and prepare raise on a Modular frame.  An embedded
    profile decodes as the JAX package decodes it: a matrix / TRC one
    (here PIL's sRGB) and one littlecms applies by a lookup table, which
    raised until the CLUT program (tests/test_torch_icc*.py)."""
    img = _rgb(16, 24)
    from PIL import ImageCms
    icc = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    for prof in (icc, F.lut_profile()):
        data = ref_api.encode(img, lossless=True, icc=prof)
        assert np.array_equal(api.decode(data, device="cpu")[0],
                              ref_api.decode(data)[0])
    plain = ref_api.encode(img, lossless=True, effort=2)
    with pytest.raises(NotImplementedError, match="host"):
        api.decode(plain, device="cpu", entropy="device")
    with pytest.raises(NotImplementedError, match="decode"):
        api.prepare(plain, device="cpu")


def test_modular_upsampling_raises():
    """Frame upsampling raised until the post stages' upsampler (A6);
    the frame now decodes as the JAX package decodes it, and only
    entropy="device" still raises."""
    hdr, fh = F.modular_headers(16, 24, 3)
    fh.upsampling = 2
    planes = [p[::2, ::2].copy() for p in F._planes(_rgb(16, 24))]
    data = F._still(hdr, lambda bw: reference.encode_modular_frame(
        bw, hdr, fh, planes))
    got = api.decode(data, device="cpu")[0]
    assert got.shape == (16, 24, 3)
    assert np.array_equal(got, ref_api.decode(data)[0])
    with pytest.raises(NotImplementedError, match="entropy"):
        api.decode(data, device="cpu", entropy="device")


def test_delta_palette_raises_invalid_jxl():
    hdr, fh = F.modular_headers(8, 12, 3)
    image = ModularImage([Channel(3, 3, -1, -1, np.arange(9, dtype=np.int32)
                                  .reshape(3, 3)),
                          Channel(12, 8, data=np.ones((8, 12), np.int32))],
                         nb_meta_channels=1)
    header = GroupHeader(transforms=[PT.Transform(
        id=1, begin_c=0, num_c=3, nb_colours=2, nb_deltas=1)])
    data = F._still(hdr, lambda bw: F._one_section(bw, hdr, fh, image, header))
    with pytest.raises(ref_api.InvalidJXLError, match="delta"):
        ref_api.decode(data)
    with pytest.raises(api.InvalidJXLError, match="delta"):
        api.decode(data, device="cpu")


# ---- (g) the fixture writer writes the JAX package's bytes ----

def _ref_headers(h, w, nch, bits, group_shift):
    """jxl_coder_tpu.api.encode's lossless headers (api.py:306-327)."""
    m = ref_hm.ImageMetadata()
    m.xyb_encoded = False
    m.bit_depth = ref_hm.BitDepth(False, bits, 0)
    ce = ref_hm.ColourEncoding()
    if nch == 1:
        ce.colour_space = ref_hm.ColourSpace.GREY
    m.colour_encoding = ce
    if nch == 4:
        ec = ref_hm.ExtraChannelInfo(type=ref_hm.ExtraChannelType.ALPHA)
        ec.bit_depth = ref_hm.BitDepth(False, bits, 0)
        m.extra_channels = [ec]
    hdr = ref_hm.ImageHeader(size=ref_hm.SizeHeader(xsize=w, ysize=h),
                             metadata=m)
    fh = ref_fhm.FrameHeader()
    fh.encoding = ref_fhm.Encoding.MODULAR
    fh.group_size_shift = group_shift
    fh.x_qm_scale = 2
    fh.ec_upsampling = [1] * len(m.extra_channels)
    fh.ec_blending_info = [ref_fhm.BlendingInfo() for _ in m.extra_channels]
    fh.restoration_filter.epf_iters = 0
    fh.restoration_filter.gab = False
    return hdr, fh


@pytest.mark.parametrize("case", ["rct", "no_rct", "palette", "rgba16_groups",
                                  "grey_groups"])
def test_fixture_writer_writes_the_jax_bytes(case):
    img = F.bench_frame(150, 140)
    if case == "rgba16_groups":
        img = np.concatenate([img, img[:, :, :1]], -1).astype(np.uint16) * 257
    elif case == "grey_groups":
        img = img[:, :, :1]
    elif case == "palette":
        img = F.posterized_frame(150, 140, levels=3)
    planes = F._planes(img)
    nch, bits = len(planes), 16 if img.dtype == np.uint16 else 8
    shift = 0 if case.endswith("groups") else 3
    pal = None
    if case == "palette":
        colours, inv = np.unique(np.stack(planes, -1).reshape(-1, 3), axis=0,
                                 return_inverse=True)
        pal = (colours.T.astype(np.int32).copy(),
               inv.reshape(img.shape[:2]).astype(np.int32))
    ycocg = case != "no_rct"
    hdr, fh = F.modular_headers(img.shape[0], img.shape[1], nch, bits,
                                group_shift=shift)
    mine = BitWriter()
    reference.encode_modular_frame(mine, hdr, fh, planes, use_ycocg=ycocg,
                                   palette=pal)
    rhdr, rfh = _ref_headers(img.shape[0], img.shape[1], nch, bits, shift)
    theirs = RefBitWriter()
    ref_codec.encode_modular_frame(theirs, rhdr, rfh, planes,
                                   use_ycocg=ycocg, palette=pal)
    assert mine.to_bytes() == theirs.to_bytes()


# ---- the kernels' own programs (csrc/modular.cuh) built with g++ ----

_KERNELS_RUN = r"""
#include <vector>
#include "modular.cuh"
using namespace jxl_modular;
// modular.cu's kernels with their threads one after another on the host:
// per chunk the helper warps' load and prep, the walking warp's walk, the
// helpers' store
static void unsqueeze_block(const Unsqueeze& u, int l0, UnsqueezeShared& sh) {
  long long left[kLines] = {0};
  for (int k0 = 0; k0 < u.na; k0 += kChunk) {
    for (int h = 0; h < kLines * kHelpers; ++h)
      u.load(h, kHelpers, l0, k0, sh.avg[0], sh.res[0]);
    for (int h = 0; h < kLines * kHelpers; ++h)
      u.prep(h, kHelpers, l0, k0, sh.avg[0], sh.res[0], sh.rec[0], sh.ok[0]);
    for (int t = 0; t < kLines; ++t)
      u.walk(t, kHelpers, l0, k0, sh.rec[0], sh.ok[0], sh.out[0], left[t]);
    for (int h = 0; h < kLines * kHelpers; ++h)
      u.store(h, kHelpers, l0, k0, sh.out[0]);
  }
}
extern "C" void unsqueeze_host(const int* avg, long long avg_rs,
                               const int* res, long long res_rs, int* out,
                               int lines, int na, int nr, int horizontal) {
  const Unsqueeze u = unsqueeze_of(avg, avg_rs, res, res_rs, out, lines, na,
                                   nr, horizontal);
  std::vector<UnsqueezeShared> sh(1);
  for (int l0 = 0; l0 < lines; l0 += kLines) unsqueeze_block(u, l0, sh[0]);
}
// jxl_unsqueeze_batch: every block of the launch, its channel found in the
// table as the kernel finds it
extern "C" void unsqueeze_batch_host(const void* table, int n,
                                     long long blocks) {
  const UnsqueezeDesc* d = static_cast<const UnsqueezeDesc*>(table);
  std::vector<UnsqueezeShared> sh(1);
  for (long long b = 0; b < blocks; ++b) {
    const int i = unsqueeze_find(d, n, b);
    unsqueeze_block(unsqueeze_of(d[i]), (int)(b - d[i].block0) * kLines,
                    sh[0]);
  }
}
// the walker's int32 step from its record against unsqueeze_step<int>, and
// step_fits, on n steps (left, a, next, r): out[3 i .. 3 i + 2] = the
// fast step's two outputs and whether step_fits holds
extern "C" void steps_host(const int* in, int n, long long* out) {
  for (int i = 0; i < n; ++i) {
    const int left = in[4 * i], a = in[4 * i + 1], next = in[4 * i + 2],
              r = in[4 * i + 3];
    using U = unsigned;
    const Step s{a, r, (int)(2u * ((U)a - (U)next)),
                 (int)(6u - 3u * (U)next - (U)a)};
    int first, second;
    unsqueeze_fast(left, s, first, second);
    out[3 * i] = first;
    out[3 * i + 1] = second;
    out[3 * i + 2] = step_fits(a, next, r);
  }
}
extern "C" void rct_host(const int* c0, const int* c1, const int* c2,
                         int* out, long long n, int rct_type) {
  for (long long i = 0; i < n; ++i) {
    long long o[3];
    rct_components(c0[i], c1[i], c2[i], rct_type % 7, o);
    for (int k = 0; k < 3; ++k)
      out[rct_channel(rct_type / 7, k) * n + i] = (int)o[k];
  }
}
extern "C" void palette_host(const int* pal, long long pal_rs, int nb,
                             const int* idx, int* out, long long n,
                             int num_c) {
  for (long long i = 0; i < n; ++i)
    for (int c = 0; c < num_c; ++c)
      out[c * n + i] = palette_value(pal + c * pal_rs, nb, idx[i]);
}
"""


@pytest.fixture(scope="module")
def kernels_host(tmp_path_factory):
    """csrc/modular.cuh's kernel programs built for the host with g++."""
    import ctypes
    import shutil
    import subprocess
    from jxl_coder_tpu_torch import _build
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's host codec; it is needed here too"
    tmp = tmp_path_factory.mktemp("modular")
    cpp, so = tmp / "run.cpp", tmp / "librun.so"
    cpp.write_text(_KERNELS_RUN)
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", str(_build.CSRC), "-o", str(so),
                    str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i64, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.unsqueeze_host.argtypes = [p, i64, p, i64, p, i, i, i, i]
    lib.unsqueeze_batch_host.argtypes = [p, i, i64]
    lib.steps_host.argtypes = [p, i, p]
    lib.rct_host.argtypes = [p, p, p, p, i64, i]
    lib.palette_host.argtypes = [p, i64, i, p, p, i64, i]
    return lib


def _kernel_unsqueeze(lib, avg, res, horizontal):
    avg, res = np.ascontiguousarray(avg), np.ascontiguousarray(res)
    ax = 1 if horizontal else 0
    lines, na, nr = avg.shape[1 - ax], avg.shape[ax], res.shape[ax]
    out = np.zeros((lines, na + nr) if horizontal else (na + nr, lines),
                   np.int32)
    lib.unsqueeze_host(avg.ctypes.data, avg.shape[1], res.ctypes.data,
                       res.shape[1], out.ctypes.data, lines, na, nr,
                       int(horizontal))
    return out


@pytest.mark.parametrize("horizontal", [True, False])
@pytest.mark.parametrize("lines,n", [(1, 1), (3, 2), (33, 129), (70, 131),
                                     (5, 200), (40, 64), (2, 65), (9, 80),
                                     (31, 81), (4, 161)])
def test_kernel_unsqueeze_program_equals_the_host_oracle(kernels_host,
                                                         horizontal, lines,
                                                         n):
    """Chunks of 40 steps (80 and 81 outputs end a chunk), warps of 32
    lines, ragged on both counts: the helpers' records and range flags,
    the walker's int32 step from them."""
    rng = np.random.default_rng(lines * 1000 + n)
    avg, res = _squeeze_pair(rng, lines, n, horizontal)
    assert np.array_equal(_kernel_unsqueeze(kernels_host, avg, res,
                                            horizontal),
                          _host_unsqueeze(avg, res, horizontal))


@pytest.mark.parametrize("case", ["2^29", "mixed", "int32"])
def test_kernel_unsqueeze_program_near_2_29(kernels_host, case):
    """R1's range: the kernel's int64 step is the oracle's; "mixed" lines
    cross 2^27 back and forth, between the int32 step and the int64 one,
    within a chunk and across chunks; "int32" takes averages and
    residuals from the whole int32 range, no forward squeeze's."""
    rng = np.random.default_rng(2)
    base = 1 << 29
    lines = (np.where(np.arange(150) % 4 < 2, base, -base)
             + rng.integers(-1000, 1000, (37, 150)))
    if case == "mixed":
        small = np.cumsum(rng.integers(-900, 900, (37, 150)), axis=1)
        edge = (1 << 27) - 600 + rng.integers(-800, 800, (37, 150))
        pick = rng.integers(0, 3, (37, 150))
        lines = np.where(pick == 0, lines, np.where(pick == 1, small, edge))
    avg, res = RT._squeeze_1d(lines)
    avg, res = avg.astype(np.int32), res.astype(np.int32)
    if case == "int32":
        avg = rng.integers(-2**31, 2**31, avg.shape).astype(np.int32)
        res = rng.integers(-2**31, 2**31, res.shape).astype(np.int32)
    for horizontal in (True, False):
        a, r = (avg, res) if horizontal else (avg.T.copy(), res.T.copy())
        host = _host_unsqueeze(a, r, horizontal)
        if case != "int32":
            assert np.array_equal(host, lines if horizontal else lines.T)
        assert np.array_equal(_kernel_unsqueeze(kernels_host, a, r,
                                                horizontal), host)
    # the int64 retry fires: steps fail the range check, and the int32
    # step alone would differ from the oracle on some of them
    left = _host_unsqueeze(avg, res, True)[:, 1:-1:2]
    k = min(left.shape[1], avg.shape[1] - 1)
    quads = np.stack([left[:, :k - 1], avg[:, 1:k], avg[:, 2:k + 1],
                      res[:, 1:k]], -1).reshape(-1, 4).astype(np.int32)
    fast = _fast_steps(kernels_host, quads)
    assert not fast[:, 2].all()
    oracle = _oracle_steps(quads)
    assert (fast[:, :2] != oracle).any(axis=1)[fast[:, 2] == 0].any()


def _fast_steps(lib, quads):
    """The walker's int32 step and step_fits on (left, a, next, r) rows
    -> (first, second, fits) int64 rows."""
    quads = np.ascontiguousarray(quads, np.int32)
    out = np.zeros((len(quads), 3), np.int64)
    lib.steps_host(quads.ctypes.data, len(quads), out.ctypes.data)
    return out


def _oracle_steps(quads):
    """transform._unsqueeze_1d's step in int64 on (left, a, next, r) rows,
    each output cut to int32 -> (first, second)."""
    q = quads.astype(np.int64)
    left, a, nxt, r = q.T
    diff = r + RT.smooth_tendency(left, a, nxt)
    first = a + np.sign(diff) * (np.abs(diff) >> 1)
    second = first - diff
    return np.stack([first, second], -1).astype(np.int32).astype(np.int64)


def test_kernel_unsqueeze_range_check_is_sound(kernels_host):
    """step_fits: wherever it holds and the carry is under 2^27, the int32
    step from the record equals the int64 step and the next carry is under
    2^27 again (the walk checks only a chunk's incoming carry); near the
    bound it fails on some steps, and everywhere the record's step equals
    the oracle's where both stay in range."""
    rng = np.random.default_rng(27)
    bound = 1 << 27
    n = 200_000
    mags = np.array([1000, 1 << 20, bound // 2, bound - 5000, bound,
                     1 << 29, 1 << 31], np.int64)
    pick = rng.integers(0, len(mags), (n, 4))
    q = rng.integers(-mags[pick], mags[pick], dtype=np.int64)
    # the carry must come in under 2^27; the next average near the average
    q[:, 0] = np.clip(q[:, 0], -bound, bound - 1)
    near = rng.random(n) < 0.5
    q[near, 2] = np.clip(q[near, 1] + rng.integers(-3000, 3000, near.sum()),
                         -2**31, 2**31 - 1)
    q = np.clip(q, -2**31, 2**31 - 1).astype(np.int32)
    fast = _fast_steps(kernels_host, q)
    oracle = _oracle_steps(q)
    fits = fast[:, 2] == 1
    assert 0.2 < fits.mean() < 0.8
    assert np.array_equal(fast[fits, :2], oracle[fits])
    assert ((fast[fits, 1] >= -bound) & (fast[fits, 1] < bound)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_unsqueeze_batch_equals_the_host_oracle(kernels_host, seed):
    """One batched launch (jxl_unsqueeze_batch's table, each block finding
    its channel): channels of different sizes, both axes, odd lengths and
    a one-step line, rows of a wider plane (a row stride past the width),
    values near 2^29 in one; each equals the int64 host oracle."""
    rng = np.random.default_rng(seed)
    specs = [(70, 131, True), (33, 80, False), (1, 1, True), (5, 2, False),
             (40, 41, True), (65, 9, False), (3, 200, True)]
    keep, table, want, block = [], [], [], 0
    for i, (lines, n, horizontal) in enumerate(specs):
        avg, res = _squeeze_pair(rng, lines, n, horizontal,
                                 scale=3000 if i != 4 else 1 << 28)
        if i == 0:   # a view of a wider plane: its rows' stride past na
            wide = np.zeros((avg.shape[0], avg.shape[1] + 7), np.int32)
            wide[:, :avg.shape[1]] = avg
            avg_arr, avg_rs = wide, wide.shape[1]
        else:
            avg_arr, avg_rs = avg, avg.shape[1]
        ax = 1 if horizontal else 0
        na, nr = avg.shape[ax], res.shape[ax]
        out = np.zeros((lines, na + nr) if horizontal else (na + nr, lines),
                       np.int32)
        keep += [avg_arr, res, out]
        table.append((avg_arr.ctypes.data, avg_rs, res.ctypes.data,
                      res.shape[1] if nr else 0, out.ctypes.data, lines, na,
                      nr, int(horizontal), block))
        block += -(-lines // 32)
        want.append(_host_unsqueeze(avg, res, horizontal))
    t = np.ascontiguousarray(np.asarray(table, np.int64))
    kernels_host.unsqueeze_batch_host(t.ctypes.data, len(table), block)
    for out, ref in zip(keep[2::3], want):
        assert np.array_equal(out, ref)


def test_kernel_rct_and_palette_programs_equal_the_host_oracle(kernels_host):
    rng = np.random.default_rng(42)
    for rct_type in range(42):
        planes = [rng.integers(-2**31, 2**31, (5, 8), dtype=np.int64)
                  .astype(np.int32) for _ in range(3)]
        img = RefImage([RefChannel(8, 5, data=p.copy()) for p in planes])
        RT.rct_inverse(img, RT.Transform(id=0, rct_type=rct_type))
        out = np.zeros((3, 5, 8), np.int32)
        kernels_host.rct_host(*[p.ctypes.data for p in planes],
                              out.ctypes.data, 40, rct_type)
        for c in range(3):
            assert np.array_equal(out[c], img.channels[c].data), rct_type
    for num_c, nb in ((1, 3), (3, 40), (4, 1)):
        pal = rng.integers(-5, 70000, (num_c, nb + 2)).astype(np.int32)
        idx = rng.integers(-3, nb + 9, (6, 7)).astype(np.int32)
        img = RefImage([RefChannel(nb + 2, num_c, -1, -1, pal.copy()),
                        RefChannel(7, 6, data=idx.copy())], 1)
        RT.palette_inverse(img, RT.Transform(id=1, num_c=num_c,
                                             nb_colours=nb))
        out = np.zeros((num_c, 6, 7), np.int32)
        kernels_host.palette_host(pal.ctypes.data, nb + 2, nb,
                                  idx.ctypes.data, out.ctypes.data, 42, num_c)
        for c in range(num_c):
            assert np.array_equal(out[c], img.channels[c].data)


# ---- nothing falls back ----

def test_modular_decode_on_cuda_without_a_card_raises(monkeypatch):
    data = F.modular_still(F.bench_frame(16, 24))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.decode(data)


def test_modular_kernels_build_without_nvcc_raises(monkeypatch, tmp_path):
    from jxl_coder_tpu_torch import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    _build.load.cache_clear()
    MDEV._kernels.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            MDEV._kernels()
    finally:
        _build.load.cache_clear()
        MDEV._kernels.cache_clear()
