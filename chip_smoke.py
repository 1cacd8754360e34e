"""Drive the PyTorch port's VarDCT still decode (with its post stages,
extra channels, patches, splines, reference-only and LF frames), its
Modular still decode, its sampled decode and pixel ops, its animated,
progressive and truncated decode, its JPEG recompression routes, its
encoders, its round-1 VarDCT codec and its multi-device decode and
encode on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and
prints no result):
  1. the card and the library versions;
  2. build the CUDA kernels from jxl_coder_tpu_torch/csrc with nvcc;
  3. encode the 3840x2160 d1.0 e7 frame of bench.py, a 1920x1080 d4.0
     frame (epf_iters 3), a 517x771 frame of sharp strokes (the special
     1-block transforms, a ragged size), a small 16-bit frame, a
     384x256 sharp frame at distance 0.1 (an int8 DCT8 family with an
     exception list), a two-pass (progressive) 320x256 frame and a
     single-section 232x200 frame with the repo's own host encoder
     (jxl_coder_tpu_torch.reference), cached in the temp directory by
     content hash; then the AC entropy decode's kernel (entropy="device")
     on three small streams, its plain twin on the same tables started
     in worker processes on the CPU (one step per token; not at 4K, where
     it took ~112 s: phase 6 holds the 4K kernel to the host route);
  4. each kernel against its plain PyTorch twin on the card: synthesis
     on every stream's families (the DCT8 kernel on the DCT8 family) and
     on seeded families of every strategy id 0-26; kernel 2's tile pass
     (and its EPF0 pass) on every stream's planes, on a ragged 4K crop,
     and on seeded images smaller than its halo, for epf_iters 0-3,
     per-channel gaborish weights and gaborish off, f32 / u8 / u16 out;
  5. the main path: jxl_coder_tpu_torch.api.decode(data, device="cuda")
     on every stream against the float64 host decoder, with every
     kernel's launch counter > 0, and each frame's own launches: kernel
     2 once (plus its EPF0 pass at epf_iters 3), the DCT8 kernel once;
     then again with entropy="device", counted: the entropy kernel once
     per frame, no host read_pass_group, the pixels equal to the host
     route's; and the entropy kernel against its twin (0 coefficients
     differ; status, final states and tokens equal);
  6. timings: the device half (wall time and device-busy time) and the
     whole decode at 4K by both entropy routes, split into its layers
     inside the same api.decode calls whose total it prints (the port's
     functions wrapped for those calls, in turns with unwrapped calls),
     and the parse split by its own steps (the device route's: anchors,
     upload, kernel, status read; its family gather in pack); the entropy
     kernel at 4K against the host route's coefficients (bit for bit),
     its time, tokens per group and bound; the synthesis by family (the
     DCT8 kernel apart) and kernel 2 at 4K, and kernel 2 and its EPF0
     pass on the FHD d4.0 frame's planes, each against its twin and its
     bound;
  7. the round-1 codec (jxl_coder_tpu_torch.codec): 960x540, a ragged sharp
     frame, a 16-bit frame and decoding speeds 2 and 4 encoded on the
     card (its quantised integers against the CPU encode's), each stream
     parsed once and its device half run on the card, counted: kernel 6
     once per 8-bit frame, kernel 5 (uint16 out) once per 16-bit frame,
     and none of the plain filter or output functions; against the
     port's plain path on the CPU; then kernels 5 and 6 against their
     twins on the 960x540 arrays, a ragged crop of them and seeded planes
     down to 1x1 (per-block and per-pixel inverse sigma, the four
     gaborish / EPF combinations, f32 / u8 / u16 out), and the
     epf_iters 2 route against the CPU path;
  8. the real-format fused filter entry points (kernels 3 and 4,
     instantiations of kernel 2's tile pass) on the 4K synthesised
     planes, counted, against their twins and against kernel 2; then
     against their twins on a ragged 4K crop and on seeded planes from
     1x1 up, with pad rows that are not edge copies, every output, at
     epf_iters 1 and 2;
  9. timings at 4K: the round-1 reconstruct_srgb8 / reconstruct_u16,
     kernels 5 and 6 on each route and kernels 3 and 4, each against its
     twin, and kernel 2 at the same epf_iters beside kernels 3 and 4;
 10. the DCT8-only frame path (jxl_coder_tpu_torch.vardct.dct8): kernel 7
     (detile) bit-equal to its plain version at the research probe's
     shape (a seeded permutation subset of 140,000 tile rows) and at the
     4K identity; DCT8Frame on a 3840x2160 effort-2 (all-DCT8) stream,
     counted (kernel 2 once), against the port's CPU path and the
     float64 host decoder, and on a ragged all-DCT8 frame against the
     CPU path; timings of kernel 7 (against its plain version, one
     PyTorch call and its bound) and of DCT8Frame's device time by stage;
 11. the Modular decode (streams from the port's fixture writers, encoded
     and decoded on the CPU route in the worker processes meanwhile: 4K
     RCT 6 in 12 groups, a 4K palette, FHD RGBA at 16 bits, a 1024x1024
     squeezed section, 42 groups each with its own RCT type, a small XYB
     section): the three kernels of csrc/modular.cu (unsqueeze,
     rct_inverse, palette_inverse) against their twins on seeded inputs
     (lines of 1-70 steps both ways, +-2^29, all 42 RCT types, palette
     indices out of range), 0 differences (a squeeze step's channels are
     one batched unsqueeze launch, each channel of it held to the twin); the main path api.decode(data,
     device="cuda") on every stream, counted, with the plain twins made
     to raise, each transform in a stream's headers launching its kernel
     and the XYB stream's output kernel 2 once, lossless streams equal to the
     source and the CPU route, XYB within 1 code on < 0.1%; every kernel
     call of those decodes against its twin; the 4K RCT decode split into
     its layers inside the same calls (M1); each kernel at 4K by CUDA
     graph against its twin and bound;
 12. the VarDCT post stages (streams from the port's host encoder and
     Modular fixture writer, encoded and held to the float64 host decoder
     in the worker processes meanwhile: 3840x2160 16-bit with lossy
     alpha, photon noise at ISO 3200 and PQ with BT.2100 primaries; 4K
     coded at 1920x1080 with 2x upsampling; 720x480 HLG (BT.2100), gamma
     1/2.2 and BT.709; 4x and 8x upsampled frames; a 1024x1024 RGBA
     Modular frame with 2x upsampling): the three kernels of
     csrc/post.cu (add_noise, upsample, encode_output) against their
     twins on seeded planes from 1x1 up (every output spec, 8 and 16
     bits); the main path api.decode(data, device="cuda") on every
     stream, counted, the plain twins made to raise: A5 once per noisy
     frame, A6 once per upsampled frame (and per upsampled extra
     channel), A7 once per VarDCT frame, kernel 2 once with f32 out; each
     decode within 2 codes of the float64 host decoder (PQ: mean < 0.5,
     99.9th percentile <= 8, max <= 64), extra channels equal, the
     Modular frame equal to the CPU route; the kernels against their
     twins on the main path's 4K planes; the 4K post stream and the
     upsampled 4K stream split into their layers inside the same calls
     (M1); each kernel at 4K by CUDA graph against its twin and bound;
 13. api.decode_batch (the host halves on a worker pool, the uploads,
     device halves and downloads on their own CUDA streams): 8 copies of
     the 4K d1.0 e7 stream on each entropy route, and a mixed batch of
     the 4K d1.0 e7, 4K RGBA16 noise + PQ, 4K-from-FHD 2x and 4K Modular
     RCT streams with the FHD d4.0 and 720x480 16-bit ones (host route):
     each once, counted, the plain twins made to raise; then each batch
     timed (the median of 2 calls) against N sequential api.decode calls
     on the same bytes and route, in turns, every output equal to
     api.decode's (0 codes), with the host halves' time alone and in the
     batch, the CPU used, the peak device memory and the card's busy
     share of a profiled batch call, at the pipeline's own worker count
     and files in flight (no longer swept);
 14. patches, splines, reference-only and LF frames (streams written and
     held to the float64 host decoder in the worker processes during
     phases 3-5: the 3840x2160 text of port_fixtures.text_frame at d1.0
     e7, which the host encoder writes as a Modular reference-only atlas
     frame and a VarDCT frame with patches; the 4K d1.0 e7 stream with 64
     seeded splines spliced into its LfGlobal; the same stream rewritten
     as a Modular LF frame and the VarDCT frame with kUseDcFrame; a
     VarDCT reference-only frame that patches read in every blend mode; a
     patched 512x384 frame with alpha): api.decode(data, device="cuda")
     on every stream and both entropy routes (the alpha frame: the host
     route, the device route raising), counted, every plain twin made to
     raise: the patch kernel A8 once per patched frame, the spline kernel
     A9 once per spline frame, kernel 2 with f32 out before them, A7 once,
     no Modular transform; each decode within 1 code on < 0.1% of the
     float64 host decoder, the routes equal; A8 (bit for bit) and A9
     (within 1e-6) against their twins on every stream's main-path planes;
     the three 4K streams split into their layers inside the same calls
     (M1); A8 and A9 at 4K by CUDA graph against twin, bound and the JAX
     route's dense x * mul + add; a mixed decode_batch of the three 4K
     streams, the 4K d1.0 e7 frame and the 4K Modular RCT still, equal to
     api.decode;
 15. the sampled decode (jxl_coder_tpu_torch.api.decode_sampled) on the 4K
     d1.0 e7 frame, the 4K RGBA16 noise + PQ stream of phase 12, the 4K
     text of phase 14 and the 4K Modular RCT still, at 480x270 (the
     thumbnail: the DC image, or a full decode and the 8x box S2), 960x540
     (the quarter route: the down pool S1 before the output encoding, where
     the still is eligible), 1920x1080 FIT and 1000x1000 FILL (a full
     decode and the banded resample S3), in every colour config at the
     thumbnail and in RGBA_8888 at the other targets (the reformat S4,
     with the HDR -> SDR tone map for an SDR format of the PQ stream):
     counted, every plain twin made to raise, each call's launches
     held to its route (no synthesis and no pass group on the thumbnail
     route); every S1-S4 call of those decodes against its twin (S2 and the
     packers equal, S1 and S3 within 1 code); the thumbnails against the
     float64 host thumbnail; decode_sampled split into its layers inside
     the same calls (M1) beside api.decode on the same bytes; S1-S4 at
     their 4K shapes by CUDA graph against twin, bound and, for S3, the
     dense float32 matmul pair (S4: F.pad); S3 (one launch) also on 4K
     RGBA8, the 8x Catmull-Rom upscale of a 480x270 DC image and 4K -> FIT
     480x270, each held to its twin;
 16. animation, progressive and truncated decode (streams written in the
     worker processes during phases 3-5 by port_fixtures: 6 FHD lossy
     frames, AnimatedEncoder's defaults, one frame a job; an FHD lossless
     RGB + alpha + depth sprite animation, a full background, a
     reference-only frame, eight cropped 320x240 sprites in every blend
     mode and a whole-canvas BLEND frame; 8 round-1 frames cut to 256x384;
     the 4K d1.0 e7 frame with two passes and its prefixes cut after pass
     0 and after HF global, with their float64 oracles): counted, every
     plain twin made to raise, decode_frames, get_frame in order and at
     (0, 3, 2, 5, last) and api.decode on both animations,
     decode_frames_batch on the round-1 one, decode_preview on both
     entropy routes and decode of both cuts, each call's launches held to
     its route (A10 once per composed frame, by the cursor's walk; the
     batched kernel 6 once per batch; the DC render without synthesis or
     pass group); the animations against reference.frames_float64 (the
     lossy frames within 1 code on < 0.1%, the sprites equal), get_frame
     against decode_frames; every A10 call against its twin, the batch
     against single launches, its twin and the codec's per-frame decode;
     the preview and cuts against their float64 oracles; get_frame in
     order split into its layers (M1: two split passes in turns with two
     unsplit ones,
     each split pass's layers within 2% of its total); decode_frames'
     frames per second; the 4K
     preview and cuts beside decode in turns; A10 and the batched kernel 6
     by CUDA graph against twin and bound, and A10 on a seeded u16 canvas
     of the same size and blending (held to its twin first);
 17. the JPEG routes (JPEGs written by port_fixtures.baseline_jpeg in the
     worker processes during phases 3-5, each recompressed by the port's
     api.construct or the round-1 container's writer, reconstructed byte
     for byte and given its float64 oracle there: 4K 4:2:0 and 4:4:4, FHD
     4:2:2 and 4:2:0, a ragged 4:2:0, grey, restart markers, a round-1
     container): J1, J2 (csrc/jpeg.cu) and A7 "ycbcr" against their
     twins on seeded inputs; api.decode on every stream, counted, the
     twins made to raise (J1 and J2 once a route-2 / route-3 frame and no
     synthesis; the DCT8 kernel, kernel 2 and A7 "ycbcr" once a 4:4:4 or
     grey frame), each within 1 code on < 0.1% of its oracle; the kernels
     against their twins on the main path's inputs; a mixed decode_batch
     equal to api.decode; decode_thumbnail and decode_sampled at 960x540
     on the 4K 4:4:4 and FHD 4:2:0 streams; the 4K 4:4:4 and FHD 4:2:0
     decodes split into
     their layers (M1; 4K 4:2:0's host read takes ~10 s a call); J1, J2
     and A7 "ycbcr" at 4K by CUDA graph against twin, bound and, for J1,
     the fp32 matmul pair.
 18. the encoders (api.encode, AnimatedEncoder; the 4K text's patch plan
     and the FHD lossless still at effort 7, host code, in the worker
     processes from phase 3): E1-E4 and the winners' gather
     (csrc/encode.cu) against their twins on seeded inputs from 1x1 to a
     ragged 2150x3830 crop (every candidate shape, every special
     transform, u8 / u16 / float samples); the main path api.encode(4K
     bench frame and the 517x771 sharp strokes, lossy, quality 90,
     effort 7, device="cuda"), counted, the twins and the float64 host
     front made to raise: E1 and E2 once, E3 once per shape (7), E4 once
     per special transform where blocks are eligible, the gather once;
     every E call of those encodes against its twin (values equal but at
     quantisation ties, costs within 1e-4); each stream at the float64
     host route's RD point (size within 2%, PSNR within 0.1 dB) and its
     card decode within 1 code of the float64 decoder; the 4K text through
     the patch path with the card's front; the 720x480 16-bit, RGBA,
     noise and progressive encodes against the CPU route; the FHD
     lossless still's round trip; AnimatedEncoder on four FHD lossy
     frames, decode_frames against the float64 frames; the 4K encode
     split into its layers (M1, 2 + 2 calls) beside phase 3's float64
     host-route encode of the same frame; each kernel at 4K by CUDA graph
     against twin, bound (E1's the largest of its bytes, its f32
     operations and its cbrt's float64 steps) and yardstick (the fp32
     matmul pair, index_select for the gather).
 19. the ICC step (csrc/icc.cu: littlecms's 8-bit matrix / TRC program,
     the profile read on the host) and any channel count (S2, S3, S4 past
     4 channels, A10 past 8 extra channels; the streams written as the
     last jobs of phase 3's pool): the ICC kernel against its
     twin on the whole 2^24 cube of 8-bit RGB for each of the 14 test
     profiles of port_fixtures.icc_test_profiles, and on u16 RGBA, grey,
     RGBA, 1x1 and ragged images for three (0 differences: integers, no
     tie), the cube within 1 code of the float64 model; api.decode of phase 11's 4K Modular still with a
     Display P3 profile spliced into its header, counted (the ICC kernel
     once, its twin made to raise), equal to the still without its
     profile through the twin on the CPU and within 1 code of the float64
     model, timed beside the still without it; a lossy api.encode of the
     4K bench frame with the profile, counted (the ICC kernel once, then
     E1-E4 as in phase 18), at the RD point of the encode of the twin's
     sRGB pixels; decode_thumbnail and decode_sampled of an FHD Modular
     still of RGB and 3 extra channels, counted (S2, S3, S4 once each, the
     twins made to raise), each call held to its twin; decode_frames of a
     540x960 sprite animation of RGB and 10 extra channels (every blend
     mode; A10 twice per composed frame), each A10 call held to its twin;
     the ICC kernel at 4K by CUDA graph against twin, bound and a yardstick
     of PyTorch calls (gather, fp32 matmul, where / pow), and S2, S3 and
     A10 at 4K past their old channel limits.  The CLUT program
     (clut_kernel: lookup-table profiles, black-point compensation): the
     kernel against its twin on the 2^24 cube for each CLUT profile of
     port_fixtures.lut_test_profiles (and the matrix kernel on the one
     whose sums leave int32), on u16 grey, RGBA, 1x1 and ragged images for
     two; the 4K still with the mAB profile through api.decode, counted
     (clut_kernel once), equal to the twin; the decode's added time split
     in the same calls into the host plan (cold, cached), the tables'
     upload and the kernel, for Display P3 and the mAB profile; a lossy
     encode of the 4K bench frame with the mAB profile, counted, and that
     stream decoded on the card (kernels 1 and 2); clut_kernel at 4K by
     CUDA graph against twin, bound and F.grid_sample on the CLUT.
 20. the multi-device decode and encode (jxl_coder_tpu_torch/parallel over
     torch.distributed; ranks spawned after every timed phase, sharing the
     one card): kernel 2 in a row window (the lower half of the 4K
     all-DCT8 frame's rows) bit-equal to the same rows of the whole-frame
     launch, within 1 code of its twin, timed beside it; the 4K all-DCT8
     frame (effort 2, 270 x 480 blocks) by block rows at 1 rank (NCCL)
     and at 2 and 3 ranks (gloo), and at 2 ranks with epf_iters 3, counted
     with the twins made to raise (kernel 7 and one windowed kernel-2
     launch a rank, plus its EPF0 pass at epf_iters 3), every rank's
     whole output equal to DCT8Frame's on the card (0 codes), each
     windowed launch against its twin on the rank's slab, and each rank's
     host ms split into compute, exchange and all_gather; phase 16's 8
     round-1 frames at 2 ranks: decode_frames_batch(mesh=),
     sharded_reconstruct and sharded_frame_reconstruct equal to the
     non-mesh path; in this process and in the same 2 ranks, the
     multihost workers (the GOP decode of the 4K d1.0 e7 stream, 4 frames
     a rank, each rank's frames equal to api.decode; the GOP encode of 4
     FHD frames, the bitstreams byte-identical) at 1 and 2 processes,
     their frames per second printed as contention on one card, not
     scaling.
Every kernel's line carries its bound: the larger of the bytes it must
move (each input read once, each output written once) over 3.35 TB/s
and its operations over their type's rate: 67 TFLOP/s for f32, 34 for
fp64 (the spline kernel's sums, the composition) (the H100 SXM's
published peaks at 700 W).  Calls the host cannot queue ahead of the card are timed by
replaying a CUDA graph of them.  The last two lines are the card's name
and power limit and
{"ok": true, "device": {...}}; the line before them lists the kernels
(kernel 2's row and its EPF0 pass's also count phase 20's windowed
launches, "window_launches").
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import gc
import hashlib
import importlib
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
import sys
import tempfile
import threading
import time

sys.modules["jax"] = None    # the port runs without JAX; so does this script
sys.modules["jxl_coder_tpu"] = None  # and without the JAX package

import numpy as np
import torch

from jxl_coder_tpu_torch import _build, animation, api, codec, reference
from jxl_coder_tpu_torch import batch as BATCH
from jxl_coder_tpu_torch.entropy import device as ENT
from jxl_coder_tpu_torch.jpeg import pixels as JPX
from jxl_coder_tpu_torch.host.bitstream import icc as HBICC
from jxl_coder_tpu_torch.host.jpeg import transcode as JTC
from jxl_coder_tpu_torch.host.jpeg.parser import ZIGZAG
from jxl_coder_tpu_torch.host.modular import transform as MT
from jxl_coder_tpu_torch.host.modular.frame import ModularFrameDecoder
from jxl_coder_tpu_torch.host.vardct.dec_real import BlockArrays
from jxl_coder_tpu_torch.host.vardct import enc_patches as EPAT
from jxl_coder_tpu_torch.host.vardct import enc_real as ENCR
from jxl_coder_tpu_torch.modular import device as MDEV
from jxl_coder_tpu_torch.modular import output as MOUT
from jxl_coder_tpu_torch.host.ops import icc as HICC
from jxl_coder_tpu_torch.host.ops import icc_lut as HLUT
from jxl_coder_tpu_torch.ops import compose as COMPOSE
from jxl_coder_tpu_torch.ops import icc_apply as ICC
from jxl_coder_tpu_torch.ops import pack as PACK
from jxl_coder_tpu_torch.ops import resize as RESIZE
from jxl_coder_tpu_torch.ops import sample as SAMPLE
from jxl_coder_tpu_torch.ops import tone as TONE
from jxl_coder_tpu_torch.vardct import (color, dct8, filters, inputs, post,
                                        synth)
from jxl_coder_tpu_torch.vardct import detile as DT
from jxl_coder_tpu_torch.vardct import enc_device as ENCDEV
from jxl_coder_tpu_torch.vardct import enc_kernels as EK
from jxl_coder_tpu_torch.vardct.dct import dct_matrix
from jxl_coder_tpu_torch.vardct import overlay as OV
from jxl_coder_tpu_torch.vardct import fused_filters as FF
from jxl_coder_tpu_torch.vardct import parse as PARSE
from jxl_coder_tpu_torch.vardct import pipeline as LP
from jxl_coder_tpu_torch.parallel import groups as G
from jxl_coder_tpu_torch.vardct.frame import VarDCTFrame
from port_fixtures import (animation_frame, animation_header, baseline_jpeg,
                           bench_frame, group_rct_still, header_bytes,
                           icc_test_profiles, legacy_animation,
                           lut_test_profiles, modular_still,
                           patched_alpha_still, posterized_frame,
                           seeded_splines, sharp_frame, sprite_animation,
                           squeezed_still, synthetic_family, text_frame,
                           upsampled_modular_still, vardct_reference_still,
                           waves_frame, with_icc, with_lf_frame,
                           with_splines, xyb_still)

SYNTH_TOL = 1e-4      # f32 sums in another order than the twin's matmuls
FILTER_TOL = 1e-5     # no FMA contraction; EPF SADs summed in another order
U16_TOL = 64
REPS = 10

KERNELS = {
    "synth_family": dict(fn=synth.synth_family, source="jxl_coder_tpu_torch/csrc/synth.cu",
                         replaces="jxl_coder_tpu/vardct/synth_pallas.py:129"),
    "synth_dct8": dict(fn=synth.synth_dct8, source="jxl_coder_tpu_torch/csrc/synth.cu",
                       replaces="jxl_coder_tpu/vardct/synth_pallas.py:129"),
    "restore_and_output": dict(fn=filters.restore_and_output,
                               source="jxl_coder_tpu_torch/csrc/filters.cu",
                               replaces="jxl_coder_tpu/vardct/filters_pallas.py:751"),
    "epf0_pass": dict(fn=filters.epf0_pass, source="jxl_coder_tpu_torch/csrc/filters.cu",
                      replaces="jxl_coder_tpu/vardct/filters_pallas.py:751"),
    "fused_real_filters": dict(fn=FF.fused_real_filters,
                               source="jxl_coder_tpu_torch/csrc/filters.cu",
                               replaces="jxl_coder_tpu/vardct/filters_pallas.py:588"),
    "fused_real_gab_epf1": dict(fn=FF.fused_real_gab_epf1,
                                source="jxl_coder_tpu_torch/csrc/filters.cu",
                                replaces="jxl_coder_tpu/vardct/filters_pallas.py:794"),
    "fused_gab_epf": dict(fn=FF.fused_gab_epf, source="jxl_coder_tpu_torch/csrc/fused_filters.cu",
                          replaces="jxl_coder_tpu/vardct/filters_pallas.py:80"),
    "fused_filters2": dict(fn=FF.fused_filters2, source="jxl_coder_tpu_torch/csrc/fused_filters.cu",
                           replaces="jxl_coder_tpu/vardct/filters_pallas.py:190"),
    "detile": dict(fn=DT.detile, source="jxl_coder_tpu_torch/csrc/detile.cu",
                   replaces="research/detile_probe.py:84"),
    "decode_pass_groups": dict(fn=ENT.decode_pass_groups,
                               source="jxl_coder_tpu_torch/csrc/entropy.cu",
                               replaces="jxl_coder_tpu/entropy/device.py:225"),
    "unsqueeze": dict(fn=MDEV.unsqueeze, source="jxl_coder_tpu_torch/csrc/modular.cu",
                      replaces="jxl_coder_tpu/modular/device.py:62"),
    "rct_inverse": dict(fn=MDEV.rct_inverse, source="jxl_coder_tpu_torch/csrc/modular.cu",
                        replaces="jxl_coder_tpu/modular/device.py:98"),
    "palette_inverse": dict(fn=MDEV.palette_inverse,
                            source="jxl_coder_tpu_torch/csrc/modular.cu",
                            replaces="jxl_coder_tpu/modular/device.py:162"),
    "add_noise": dict(fn=post.add_noise, source="jxl_coder_tpu_torch/csrc/post.cu",
                      replaces="jxl_coder_tpu/vardct/tpu_full.py:606"),
    "upsample": dict(fn=post.upsample, source="jxl_coder_tpu_torch/csrc/post.cu",
                     replaces="jxl_coder_tpu/vardct/tpu_full.py:632"),
    "encode_output": dict(fn=post.encode_output,
                          source="jxl_coder_tpu_torch/csrc/post.cu",
                          replaces="jxl_coder_tpu/vardct/tpu_full.py:676"),
    "overlay_patches": dict(fn=OV.overlay_patches,
                            source="jxl_coder_tpu_torch/csrc/overlay.cu",
                            replaces="jxl_coder_tpu/vardct/tpu_full.py:835"),
    "draw_splines": dict(fn=OV.draw_splines,
                         source="jxl_coder_tpu_torch/csrc/overlay.cu",
                         replaces="jxl_coder_tpu/vardct/tpu_full.py:835"),
    "encode_output_down": dict(fn=post.encode_output_down,
                               source="jxl_coder_tpu_torch/csrc/post.cu",
                               replaces="jxl_coder_tpu/vardct/tpu_full.py:862"),
    "box_codes": dict(fn=SAMPLE.box_codes, source="jxl_coder_tpu_torch/csrc/sample.cu",
                      replaces="jxl_coder_tpu/api.py:1062"),
    "rescale_image": dict(fn=RESIZE.rescale_image,
                          source="jxl_coder_tpu_torch/csrc/sample.cu",
                          replaces="jxl_coder_tpu/ops/resize.py:108"),
    "convert": dict(fn=PACK.convert, source="jxl_coder_tpu_torch/csrc/pixel_ops.cu",
                    replaces="jxl_coder_tpu/ops/pack.py:62"),
    "compose": dict(fn=COMPOSE.compose, source="jxl_coder_tpu_torch/csrc/compose.cu",
                    replaces="jxl_coder_tpu/api.py:821"),
    "legacy_filters_batch": dict(fn=FF.legacy_filters_batch,
                                 source="jxl_coder_tpu_torch/csrc/fused_filters.cu",
                                 replaces="jxl_coder_tpu/vardct/filters_pallas.py:190"),
    "jpeg_idct": dict(fn=JPX.jpeg_idct, source="jxl_coder_tpu_torch/csrc/jpeg.cu",
                      replaces="jxl_coder_tpu/jpeg/wire.py:748"),
    "ycbcr_to_rgb": dict(fn=JPX.ycbcr_to_rgb,
                         source="jxl_coder_tpu_torch/csrc/jpeg.cu",
                         replaces="jxl_coder_tpu/jpeg/wire.py:749"),
    # A7's "ycbcr" case: its launches are encode_output's on the JPEG path
    "encode_output_ycbcr": dict(fn=post.encode_output,
                                source="jxl_coder_tpu_torch/csrc/post.cu",
                                replaces="jxl_coder_tpu/vardct/tpu_full.py:685"),
    # the encoder front (jitted JAX, no Pallas kernel): E1-E4, the gather
    "enc_front_planes": dict(fn=EK.front_planes,
                             source="jxl_coder_tpu_torch/csrc/encode.cu",
                             replaces="jxl_coder_tpu/vardct/enc_device.py:111"),
    "enc_front_blocks": dict(fn=EK.front_blocks,
                             source="jxl_coder_tpu_torch/csrc/encode.cu",
                             replaces="jxl_coder_tpu/vardct/enc_device.py:120"),
    "enc_dct_costs": dict(fn=EK.dct_costs,
                          source="jxl_coder_tpu_torch/csrc/encode.cu",
                          replaces="jxl_coder_tpu/vardct/enc_device.py:174"),
    "enc_special_costs": dict(fn=EK.special_costs,
                              source="jxl_coder_tpu_torch/csrc/encode.cu",
                              replaces="jxl_coder_tpu/vardct/enc_device.py:280"),
    "enc_gather_rows": dict(fn=EK.gather_rows,
                            source="jxl_coder_tpu_torch/csrc/encode.cu",
                            replaces="jxl_coder_tpu/vardct/enc_device.py:424"),
    # the ICC -> sRGB step (littlecms on the host in the JAX package)
    "icc_to_srgb": dict(fn=ICC.transform, source="jxl_coder_tpu_torch/csrc/icc.cu",
                        replaces="jxl_coder_tpu/ops/icc_apply.py:22"),
    # its CLUT program: lookup-table profiles, moving black points
    "clut_kernel": dict(fn=ICC.clut_transform,
                        source="jxl_coder_tpu_torch/csrc/icc.cu",
                        replaces="jxl_coder_tpu/ops/icc_apply.py:22"),
}
# the round-1 encoder's sources: a change to any of them re-encodes
LEGACY_ENCODER = [sys.modules[m].__file__ for m in (
    "jxl_coder_tpu_torch.codec", "jxl_coder_tpu_torch.vardct.pipeline",
    "jxl_coder_tpu_torch.vardct.dct", "jxl_coder_tpu_torch.vardct.xyb",
    "jxl_coder_tpu_torch.ops.color", "jxl_coder_tpu_torch.ops.fp")]
ERR = {k: 0.0 for k in KERNELS}
# per kernel at the main path's shape: (bound ms, "bytes" | "operations")
# and the time of one PyTorch call computing the same function (or None)
BOUND = {}
LIBRARY_MS = {k: None for k in KERNELS}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published, 700 W
F32_OPS_PER_S = 67e12         # f32 outside the tensor cores
# the least f32 operations per output pixel each function needs (an FMA
# counts 2, |x| is an operand modifier):
#   gaborish, per channel: the horizontal pair sum (1), the 4 edge taps
#     from it (2), the 4 corners from the pair sums above and below (1),
#     centre x w0 + edges x w1 + corners x w2 (5): 3 x 9;
#   EPF pass 1: two channel-weighted difference planes, horizontal and
#     vertical neighbours (2 x 3 x (sub + FMA) = 18), the 5-tap cross sum
#     of each (2 x 4; the offsets (0, -1) and (-1, 0) read the sums of the
#     pixel to the left / above), 4 weights (FMA + max, 12) and the border
#     scale (1), the weight sum (4), 4 x 3 FMAs into the numerators (24)
#     and the normalisation (4): 71;
#   EPF pass 2 and the round-1 EPF: as pass 1 with one-pixel SADs, so no
#     cross sums: 63;
#   EPF pass 0, the 12-offset diamond: six difference planes (1 and 2
#     pixels along each axis, both diagonals; 6 x 3 x (sub + FMA) = 36),
#     the cross sum of each (6 x 4; each negative offset reads the sum
#     of the pixel it points to), 12 weights (24) and the border scale
#     (1), the weight sum (12), 12 x 3 FMAs into the numerators (72) and
#     the normalisation (4): 173;
#   the sRGB output 69;
#   the round-1 sRGB codes (kernels 5 and 6): the three cubes and biases
#     (12), the opsin mix (3 x (1 + 2 FMAs) = 15), and per channel the
#     clip (2), the code from its tables (at 16 bits the quadratic, 4,
#     and its rounding, 1; glibc's powf in the twin is a table read in
#     the kernel) and the clip to the code range (1): 51
OPS_PX = {"gaborish": 27, "epf0": 173, "epf1": 71, "epf2": 63, "srgb": 69,
          "codes": 51}
# the entropy decode is one serial chain per group, not a rate: its least
# time is the longest group's tokens, each at least the dependent chain
# of the alias entry's load from L1 (33 cycles, Hopper's L1 hit latency
# in published microbenchmarks) and the rANS state's multiply-add
# (4 cycles), at the card's highest SM clock
CHAIN_CYCLES = 33 + 4


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_of(moved: int, ops: float, rate: float = F32_OPS_PER_S) -> tuple:
    """(the least ms the card could take, "bytes" | "operations"): bytes
    moved over the memory rate or operations over their type's rate,
    whichever is larger."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def note_bound(name: str, moved: int, ops: float,
               rate: float = F32_OPS_PER_S, kind: str = "f32",
               also: tuple = None) -> None:
    """BOUND[name] from bound_of (f32 operations unless said), printed;
    also: a second kind of operations (ops, rate, kind), the bound then
    the largest of the three times, the line naming the term that sets
    it."""
    BOUND[name] = bound_of(moved, ops, rate)
    terms = [("bytes", moved / HBM_BYTES_PER_S * 1e3),
             (f"{kind} operations", ops / rate * 1e3)]
    what = f"{ops / 1e9:.2f} G {kind} ops"
    if also is not None:
        terms.append((f"{also[2]} operations", also[0] / also[1] * 1e3))
        what += f", {also[0] / 1e9:.2f} G {also[2]} ops"
        if terms[2][1] > BOUND[name][0]:
            BOUND[name] = (terms[2][1], "operations")
    top = max(terms, key=lambda t: t[1])
    print(f"bound {name}: {moved / 1e6:.1f} MB, {what} -> "
          f"{BOUND[name][0]:.4f} ms ({BOUND[name][1]}, set by the {top[0]}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in terms) + ")", flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# seconds of each encode cached() ran in this process, by (h, w, params)
ENCODE_S = {}


def cached(img: np.ndarray, params: str, sources, encode) -> bytes:
    """encode() of img, cached in the temp directory under the image, the
    parameters and the encoder's sources; ENCODE_S keeps the time of each
    encode it runs."""
    h, w, _ = img.shape
    key = hashlib.sha256(img.tobytes())
    key.update(f"{img.shape},{img.dtype},{params}".encode())
    for src in sources:
        with open(src, "rb") as f:
            key.update(f.read())
    path = os.path.join(tempfile.gettempdir(),
                        f"jxl_coder_tpu_torch_{key.hexdigest()[:16]}.jxl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    t0 = time.perf_counter()
    data = encode()
    ENCODE_S[(h, w, params)] = time.perf_counter() - t0
    print(f"encoded {w}x{h} {params}: {len(data)} bytes in "
          f"{ENCODE_S[(h, w, params)]:.1f} s", flush=True)
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)
    return data


def stream(img: np.ndarray, distance: float, effort: int,
           bits16: bool = False, progressive: bool = False) -> bytes:
    # 8-bit input signalled at 16 bits: the 16-bit input path of the
    # encoder needs JAX (ops.color), the 16-bit output path does not
    return cached(img, f"d{distance} e{effort} bits16 {bits16} progressive "
                  f"{progressive}",
                  [sys.modules[reference.encode_vardct.__module__].__file__],
                  lambda: reference.encode_vardct(
                      img, distance=distance, effort=effort,
                      bit_depth=16 if bits16 else None,
                      progressive=progressive))


def legacy_stream(img: np.ndarray, distance: float, speed: int) -> bytes:
    """A round-1 stream from the port's own encoder, on the card."""
    return cached(img, f"round-1 d{distance} speed {speed}", LEGACY_ENCODER,
                  lambda: codec.encode_vardct_still(
                      img, distance, decoding_speed=speed, device="cuda"))


def prepared(data: bytes, device):
    cfg, inp, _hdr = api.prepare(data, device)
    return cfg, inp


def cuda_ms(fn) -> float:
    """Median milliseconds of fn() over REPS warm runs, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


REFUSED = set()   # kernels whose wrapper refused an unaligned view


def refuses_unaligned(name: str, call, t: torch.Tensor) -> None:
    """call(view), with view a contiguous copy of t that starts 4 bytes
    past a 16-byte boundary, must raise ValueError before it launches: the
    kernel reads t in 16-byte loads.  Once a kernel."""
    if name in REFUSED:
        return
    REFUSED.add(name)
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = buf[4 // t.element_size():][:t.numel()].view(t.shape)
    view.copy_(t)
    try:
        call(view)
    except ValueError as e:
        print(f"check {name}: an unaligned view is refused ({e})",
              flush=True)
        return
    raise AssertionError(f"{name}: a view 4 bytes off a 16-byte boundary "
                         f"was not refused")


def note_err(name: str, err: float, tol: float, what: str) -> None:
    ERR[name] = max(ERR[name], float(err))
    print(f"parity {name:12s} {what}: max_abs_err {err:.3g} (tol {tol})",
          flush=True)
    if not err <= tol:
        raise AssertionError(f"{name} disagrees with its twin on {what}: "
                             f"{err} > {tol}")


def drive(what: str, fn, expect):
    """Run fn() with every kernel's launch count at 0; returns its result
    and the counts of the kernels in `expect`, each of which it must
    have launched."""
    for spec in KERNELS.values():
        spec["fn"].launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {k: KERNELS[k]["fn"].launches for k in expect}
    print(f"{what} launches: {counts}", flush=True)
    for k, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by {what}")
    return out, counts


def note_codes(name: str, got: torch.Tensor, ref: torch.Tensor, bits16: bool,
               what: str) -> None:
    """uint8 within 1 code on < 0.1% of values; uint16 within U16_TOL."""
    d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
    frac = (d > 0).float().mean().item()
    note_err(name, d.max().item(), U16_TOL if bits16 else 1,
             f"{what} (differing share {frac:.2g})")
    if not bits16 and frac >= 1e-3:
        raise AssertionError(f"{name}: u8 output differs on {frac:.3g} of "
                             f"values ({what})")


def synth_kernel(fam) -> str:
    """The KERNELS entry that synth_family launches for fam."""
    return "synth_dct8" if synth.is_dct8(fam) else "synth_family"


def check_synth(cfg, inp, label: str) -> None:
    dev = inp.dc.device
    for fam in inp.families:
        a = torch.zeros((3, cfg.H8, cfg.W8), device=dev)
        b = torch.zeros_like(a)
        synth.synth_family(a, fam, inp.dc, inp.qm)
        synth.synth_family_plain(b, fam, inp.dc, inp.qm)
        nf = synth.n_fixes(fam)
        note_err(synth_kernel(fam), (a - b).abs().max().item(), SYNTH_TOL,
                 f"{label} sid {fam.sid} {str(fam.coef.dtype)[6:]}"
                 f"{f' +{nf} fixes' if nf else ''}")


def check_synth_all_strategies(dev) -> None:
    rng = np.random.default_rng(0)
    for sid in range(27):
        for dt in (np.int8, np.int16, np.int32):
            desc, fam, ys, xs = synthetic_family(
                sid, dt, rng, fixes=dt is np.int8)
            f = inputs.family_from_dict(fam, desc, dev)
            dc = torch.from_numpy(rng.uniform(-0.05, 0.7, (3, ys, xs))
                                  .astype(np.float32)).to(dev)
            qm = np.asarray([0.8, 1.0, 0.64], np.float32)
            a = torch.zeros((3, ys * 8, xs * 8), device=dev)
            b = torch.zeros_like(a)
            synth.synth_family(a, f, dc, qm)
            synth.synth_family_plain(b, f, dc, qm)
            k = synth_kernel(f)
            ERR[k] = max(ERR[k], (a - b).abs().max().item())
    for k in ("synth_dct8", "synth_family"):
        note_err(k, ERR[k], SYNTH_TOL,
                 "seeded families, strategies 0-26 x int8/16/32")


FILTER_OUTS = ("f32", "u8", "u16")


def check_restore(planes, sigma, gab, iters, gabw, p0, p2, label: str) -> None:
    """Kernel 2's tile pass against its plain version for every output:
    f32 within FILTER_TOL, u8 within 1 code on < 0.1%, u16 within
    U16_TOL; the EPF0 pass alone at epf_iters 3."""
    for out in FILTER_OUTS:
        got = filters.restore_and_output(planes, sigma, gab, iters, gabw, p0,
                                         p2, out)
        ref = filters.restore_and_output_plain(planes, sigma, gab, iters,
                                               gabw, p0, p2, out)
        what = f"{label} gab {gab} epf_iters {iters} {out}"
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(ref.shape)} {ref.dtype}")
        if out == "f32":
            note_err("restore_and_output", (got - ref).abs().max().item(),
                     FILTER_TOL, what)
        else:
            note_codes("restore_and_output", got, ref, out == "u16", what)
    if iters == 3:
        note_err("epf0_pass", (filters.epf0_pass(planes, sigma, gab, gabw, p0)
                               - filters.epf0_pass_plain(planes, sigma, gab,
                                                         gabw, p0)
                               ).abs().max().item(), FILTER_TOL,
                 f"{label} gab {gab}")


NONUNIFORM_GABW = (0.12, 0.05, 0.115169525, 0.061248592, 0.09, 0.07)


def check_filters(planes, sigma, cfg, label: str) -> None:
    """Kernel 2 against its plain version for epf_iters 0-3 on the given
    (3, H, W) view, with the stream's gaborish weights, per-channel
    weights and gaborish off."""
    for iters in (0, 1, 2, 3):
        check_restore(planes, sigma, True, iters, cfg.gabw, cfg.pass0_scale,
                      cfg.pass2_scale, label)
    check_restore(planes, sigma, True, 2, NONUNIFORM_GABW, cfg.pass0_scale,
                  cfg.pass2_scale, label + " per-channel gaborish")
    check_restore(planes, sigma, False, 3, cfg.gabw, cfg.pass0_scale,
                  cfg.pass2_scale, label)


def check_filters_tiny(dev) -> None:
    """Images smaller than the halo (Mirror() folds more than once) and a
    ragged size, seeded planes and sigma with inactive blocks."""
    rng = np.random.default_rng(7)
    for h, w in ((3, 5), (7, 2), (1, 1), (13, 21)):
        x = torch.from_numpy(rng.uniform(-0.05, 0.6, (3, h, w))
                             .astype(np.float32)).to(dev)
        sig = torch.from_numpy(rng.uniform(0.0, 2.5, (-(-h // 8), -(-w // 8)))
                               .astype(np.float32)).to(dev)
        for iters in (0, 1, 2, 3):
            for gab, gabw in ((True, NONUNIFORM_GABW), (False, NONUNIFORM_GABW)):
                check_restore(x, sig, gab, iters, gabw, 0.9, 6.5, f"{h}x{w}")


def device_rows(fn, runs: int, tries: int = 2):
    """torch.profiler over `runs` warm calls of fn: [(device us, calls,
    kernel name)] for the device-side events, or None.  Late in a long
    process the profiler drops kernel records (4 calls of 10 seen, or
    none at all), so a profile in which some kernel's count is not a
    multiple of `runs` is taken again, up to `tries` times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        rows = [(ev.self_device_time_total, ev.count, ev.key)
                for ev in prof.key_averages()
                if str(ev.device_type).endswith("CUDA")
                and ev.self_device_time_total > 0]
        if rows and all(r[1] % runs == 0 for r in rows):
            return rows
        print(f"the profiler saw {sorted({r[1] for r in rows})} calls per "
              f"kernel over {runs} runs; profiling again", flush=True)
    return None


# whether the profiler still gives whole profiles in this process: once
# every try of a call has dropped records it keeps dropping them (44 of 46
# such calls in one full run of this script on the H100, 54 of 55 in
# another), and each try of a twin costs seconds, so later calls skip it;
# the seconds the failed tries took
PROFILER = {"whole": True, "failed_s": 0.0, "skipped": 0}


def device_ms(fn, n: int = 50) -> float:
    """Device milliseconds per call of fn.  CUDA events around n
    back-to-back calls time the card's own work (a few us between
    launches included) when the host queues the calls in under 0.8 of
    that time; otherwise (short kernels, twins of many small ops) the
    profiler's device-busy time, and where no profile is whole either
    (or the profiler has stopped giving whole ones, PROFILER), the event
    time as an upper bound, said so in the output."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    s.record()
    for _ in range(n):
        fn()
    e.record()
    queued = (time.perf_counter() - t0) * 1e3
    e.synchronize()
    total = s.elapsed_time(e)
    if queued < 0.8 * total:
        return total / n
    if not PROFILER["whole"]:
        PROFILER["skipped"] += 1
        print(f"  (host-bound, the profiler no longer whole: {total / n:.3f} "
              f"ms is an upper bound)", flush=True)
        return total / n
    t0 = time.perf_counter()
    rows = device_rows(fn, REPS)
    if rows is not None:
        return sum(r[0] for r in rows) / 1e3 / REPS
    PROFILER["whole"] = False
    PROFILER["failed_s"] += time.perf_counter() - t0
    print(f"  (host-bound and no whole profile: {total / n:.3f} ms is an "
          f"upper bound)", flush=True)
    return total / n


def graph_ms(fn, n: int = 50) -> float:
    """Device milliseconds per call of fn from replays of one CUDA graph
    that holds n back-to-back calls (CUDA events around each replay;
    median of 3): the card's own time, without the host's launch work
    between the calls.  fn must be capturable: kernel launches on the
    current stream and device allocations, no copy from the host."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    del g
    return statistics.median(times)


def profile_stage(frame, inp, runs: int = 5) -> float:
    """Device-busy ms per warm stage run (every kernel and copy, without
    the host time between them); prints the time by kernel."""
    rows = device_rows(lambda: frame(inp), runs)
    if rows is None:
        return device_ms(lambda: frame(inp))
    busy = sum(r[0] for r in rows) / 1e3 / runs
    print(f"profile 4k stage: device busy {busy:.3f} ms per run", flush=True)
    for us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {us / 1e3 / runs:8.3f} ms/run  {count // runs:4d} "
              f"calls/run  {key[:90]}", flush=True)
    return busy


LEGACY_OUTS = ("f32", "u8", "u16")
# what the round-1 pipeline must not run on the card: the per-pixel
# inverse sigma map and the plain filter and output chains
LEGACY_PLAIN = ("inv_sigma_map", "inv_sigma_blocks", "apply_filters",
                "xyb_to_srgb8", "xyb_to_u16")


@contextlib.contextmanager
def forbidden(module, names):
    """Make module.<name> raise while the block runs."""
    saved = {n: getattr(module, n) for n in names}

    def stop(name):
        def ran(*_a, **_k):
            raise AssertionError(f"{module.__name__}.{name} ran on the "
                                 f"card's path")
        return ran

    for n in names:
        setattr(module, n, stop(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(module, n, f)


def legacy_kernel(out: str) -> str:
    """The KERNELS entry legacy_filters counts toward for `out`."""
    return "fused_filters2" if out == "u8" else "fused_gab_epf"


def note_legacy(name: str, got, ref, out: str, what: str) -> None:
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(ref.shape)} {ref.dtype}")
    if out == "f32":
        note_err(name, (got - ref).abs().max().item(), FILTER_TOL, what)
    else:
        note_codes(name, got, ref, out == "u16", what)


def check_legacy_kernels(img: torch.Tensor, qf: torch.Tensor,
                         distance: float, label: str, qf_row: int = 0) -> None:
    """Kernels 5 and 6 against their twins on (3, H, W) planes: the
    pipeline's route (the per-block quant field) for the four gaborish /
    EPF combinations and every output, then the padded JAX-interface
    entry points with the per-pixel map."""
    for gab, epf in ((True, True), (True, False), (False, True),
                     (False, False)):
        for out in LEGACY_OUTS:
            args = (img, qf, distance, gab, epf, out, qf_row)
            note_legacy(legacy_kernel(out), FF.legacy_filters(*args),
                        FF.legacy_filters_plain(*args), out,
                        f"{label} gab {gab} epf {epf} {out}, per block")
    inv = FF.block_inv(qf, distance, *img.shape[1:], qf_row)
    padded, inv_p = LP.pad_rows(img, FF.PAD), LP.pad_rows(inv, FF.PAD)
    stacked = torch.cat([padded, inv_p[None]])
    note_legacy("fused_gab_epf", FF.fused_gab_epf(stacked),
                FF.fused_gab_epf_plain(stacked), "f32",
                f"{label} fused_gab_epf, padded per-pixel map")
    for to_srgb in (False, True):
        note_legacy("fused_filters2", FF.fused_filters2(padded, inv_p, to_srgb),
                    FF.fused_filters2_plain(padded, inv_p, to_srgb),
                    "u8" if to_srgb else "f32",
                    f"{label} fused_filters2 to_srgb {to_srgb}, padded "
                    f"per-pixel map")


def check_legacy_small(dev) -> None:
    """Kernels 5 and 6 on seeded planes smaller than a tile and at ragged
    sizes, on planes padded for the epf_iters >= 2 route (the field read
    from row -2), and that route end to end against the CPU path."""
    rng = np.random.default_rng(11)
    for h, w in ((3, 5), (7, 2), (1, 1), (13, 21), (21, 45), (13, 30),
                 (9, 17), (70, 131)):
        x = torch.from_numpy(rng.uniform(-0.05, 0.6, (3, h, w))
                             .astype(np.float32)).to(dev)
        qf = torch.from_numpy(rng.integers(1, 40, (-(-h // 8), -(-w // 8)))
                              .astype(np.int32)).to(dev)
        check_legacy_kernels(x, qf, 1.25, f"{h}x{w}")
        if h == 70:
            check_legacy_kernels(x, qf, 1.25, f"{h}x{w} from row -2", -2)
    img = bench_frame(64, 96)
    ac, dc, qf = (t.cpu() for t in codec.quantize_still(img, 1.0, "cpu"))
    cfl = (torch.zeros((1, 2), dtype=torch.int32),
           torch.full((1, 2), 64, dtype=torch.int32))
    cpu_args = (ac.to(torch.int16), dc, qf) + cfl + (1.0,)
    card_args = tuple(t.to(dev) for t in cpu_args[:5]) + (1.0,)
    for fn, out in ((LP.reconstruct_xyb, "f32"), (LP.reconstruct_srgb8, "u8"),
                    (LP.reconstruct_u16, "u16")):
        for gab in (True, False):
            note_legacy(legacy_kernel(out),
                        fn(*card_args, epf_iters=2, gab=gab).cpu(),
                        fn(*cpu_args, epf_iters=2, gab=gab), out,
                        f"round-1 {fn.__name__} epf_iters 2 gab {gab} vs "
                        f"the CPU path")


def legacy_codec(dev) -> dict:
    """Phase 7: the round-1 codec through jxl_coder_tpu_torch.codec."""
    frames = {  # label: (image, distance, decoding speed)
        # 960x540: round-1's pure-Python entropy coding took 16 s to write
        # and 20 s to parse an FHD frame; kernels 5 and 6 are timed at 4K
        "qhd_d1.0": (bench_frame(540, 960), 1.0, 0),
        "sharp_d1.0": (sharp_frame(517, 771), 1.0, 0),
        "16bit_d1.0": (bench_frame(480, 720).astype(np.uint16) * 257, 1.0, 0),
        "speed2_d1.0": (bench_frame(256, 384), 1.0, 2),
        "speed4_d1.0": (bench_frame(256, 384), 1.0, 4)}
    parsed = {}
    for label, (img, d, speed) in frames.items():
        # the card's quantised integers against the CPU encode's
        card_q = codec.quantize_still(img, d, dev)
        host_q = codec.quantize_still(img, d, "cpu")
        for name, a, b in zip(("AC", "DC"), card_q, host_q):
            diff = (a.cpu().long() - b.long()).abs()
            print(f"legacy {label}: quantised {name} card vs CPU: differing "
                  f"share {(diff > 0).double().mean().item():.3g}, max "
                  f"{diff.max().item()}", flush=True)
        data = legacy_stream(img, d, speed)
        t0 = time.perf_counter()
        cs, hdr, fh, toc = api._read_frame(data)
        parsed[label] = (img, codec.read_vardct_still(cs, hdr, fh, toc), hdr, fh)
        print(f"legacy {label}: {len(data)} bytes, gab {fh.restoration_filter.gab} "
              f"epf_iters {fh.restoration_filter.epf_iters} bits "
              f"{hdr.metadata.bit_depth.bits_per_sample}, host parse "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    kernels = ("fused_gab_epf", "fused_filters2")

    def decode_all():
        outs, per_frame = {}, {}
        for label, (_img, fd, hdr, fh) in parsed.items():
            before = {k: KERNELS[k]["fn"].launches for k in kernels}
            outs[label] = codec.reconstruct_vardct_still(fd, hdr, fh, "cuda")
            per_frame[label] = {k: KERNELS[k]["fn"].launches - before[k]
                                for k in kernels}
        return outs, per_frame

    with forbidden(LP, LEGACY_PLAIN):
        (outs, per_frame), counts = drive(
            "round-1 codec (codec.reconstruct_vardct_still on the card)",
            decode_all, kernels)
    for label, (_img, _fd, hdr, _fh) in parsed.items():
        bits = hdr.metadata.bit_depth.bits_per_sample
        want = {"fused_filters2": int(bits <= 8), "fused_gab_epf": int(bits > 8)}
        print(f"legacy frame {label} ({bits} bits) launches: "
              f"{per_frame[label]}", flush=True)
        if per_frame[label] != want:
            raise AssertionError(f"legacy {label}: launches "
                                 f"{per_frame[label]}, expected {want}")
    for label, (img, fd, hdr, fh) in parsed.items():
        ref = codec.reconstruct_vardct_still(fd, hdr, fh, "cpu")
        got = outs[label]
        if got.shape != img.shape or got.dtype != img.dtype or \
                got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"legacy {label}: {got.shape} {got.dtype}, "
                                 f"CPU {ref.shape} {ref.dtype}, source "
                                 f"{img.shape} {img.dtype}")
        d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
        frac = float((d > 0).mean())
        src = np.abs(got.astype(np.float64) - img).mean()
        print(f"legacy decode {label}: {got.dtype} vs the port's CPU path max "
              f"{d.max()} code, differing share {frac:.3g}; mean |decoded - "
              f"source| {src:.3f} codes", flush=True)
        if got.dtype == np.uint16:
            if d.max() > U16_TOL:
                raise AssertionError(f"legacy {label}: outside {U16_TOL} codes")
        elif d.max() > 1 or frac >= 1e-3:
            raise AssertionError(f"legacy {label}: outside 1 code / 0.1%")
    # kernels 5 and 6 against their twins on the 960x540 arrays, whole and
    # a ragged crop of them
    a = LP.inputs_from_frame_data(parsed["qhd_d1.0"][1], dev)
    _, ny, nx, _, _ = a.ac.shape
    fx, fb = LP.expand_cfl(a.cfl_x, a.cfl_b, ny, nx)
    img = LP.dequant_idct(a.ac, a.dc, a.qf, fx, fb, a.distance)
    check_legacy_kernels(img, a.qf, a.distance, "960x540")
    check_legacy_kernels(img[:, :535, :957], a.qf, a.distance,
                         "crop 535x957")
    check_legacy_small(dev)
    return counts


REAL_OUTS = {"f32": (False, 8), "u8": (True, 8), "u16": (True, 16)}
# kernel 4 is gaborish + EPF1 with f32 or sRGB8 out
REAL_CASES = [("fused_real_filters", it, kind) for it in (1, 2)
              for kind in REAL_OUTS] + [("fused_real_gab_epf1", 1, kind)
                                        for kind in ("f32", "u8")]


def real_call(name: str, it: int, kind: str, plain: bool = False):
    """The entry point (or its twin) of kernel 3 or 4 for one case."""
    to_srgb, bits = REAL_OUTS[kind]
    if name == "fused_real_filters":
        fn = FF.fused_real_filters_plain if plain else FF.fused_real_filters
        return lambda xp, inv, p2: fn(xp, inv, it, p2, to_srgb=to_srgb,
                                      bits=bits)
    fn = FF.fused_real_gab_epf1_plain if plain else FF.fused_real_gab_epf1
    return lambda xp, inv, p2: fn(xp, inv, to_srgb)


def note_real(name: str, got, ref, kind: str, what: str) -> None:
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name} {what}: {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(ref.shape)} {ref.dtype}")
    if kind == "f32":
        note_err(name, (got - ref).abs().max().item(), FILTER_TOL, what)
    else:
        note_codes(name, got, ref, kind == "u16", what)


def check_real(xp, inv, p2: float, label: str) -> None:
    """Kernels 3 and 4 against their twins in every case."""
    for name, it, kind in REAL_CASES:
        note_real(name, real_call(name, it, kind)(xp, inv, p2),
                  real_call(name, it, kind, plain=True)(xp, inv, p2), kind,
                  f"{label} epf_iters {it} {kind}")


def pad_not_edge(img: torch.Tensor, rng) -> torch.Tensor:
    """(3, H, W) planes row-padded by FF.PAD rows that are not edge
    copies: seeded noise about each plane's mean (the padded interface
    reads them as the image's neighbours)."""
    mean = img.mean(dim=(1, 2), keepdim=True)
    noise = torch.from_numpy(rng.normal(0.0, 0.05, (2, 3, FF.PAD, img.shape[2]))
                             .astype(np.float32)).to(img.device)
    return torch.cat([mean + noise[0], img, mean + noise[1]], 1)


def real_fused(xyb: torch.Tensor, sigma: torch.Tensor, cfg) -> dict:
    """Phase 8: kernels 3 and 4 through their entry points on the 4K
    synthesised planes row-padded by 4 (edge copies), counted, against
    their twins and kernel 2's tile pass (f32 output); then against their
    twins on a ragged crop and seeded planes whose pad rows are not edge
    copies."""
    xp = LP.pad_rows(xyb, FF.PAD)
    inv1 = filters.epf_inv(sigma, 1.0)
    p2 = cfg.pass2_scale

    def run():
        return {case: real_call(*case)(xp, inv1, p2) for case in REAL_CASES}

    outs, counts = drive("the real-format fused filter entry points", run,
                         ("fused_real_filters", "fused_real_gab_epf1"))
    for (name, it, kind), got in outs.items():
        note_real(name, got, real_call(name, it, kind, plain=True)(xp, inv1, p2),
                  kind, f"4k epf_iters {it} {kind}")
    gabw = (FF.DEFAULT_GW1, FF.DEFAULT_GW2) * 3
    for it in (1, 2):
        chain = filters.restore_and_output(xyb, sigma, True, it, gabw,
                                           cfg.pass0_scale, p2, "f32")
        note_err("fused_real_filters",
                 (outs["fused_real_filters", it, "f32"] - chain).abs().max().item(),
                 FILTER_TOL, f"4k epf_iters {it} vs kernel 2")
        if it == 1:
            inner = (outs["fused_real_gab_epf1", 1, "f32"] - chain)[:, 2:-2, 2:-2]
            note_err("fused_real_gab_epf1", inner.abs().max().item(), FILTER_TOL,
                     "4k vs kernel 2, 2 px from the border inward")
    rng = np.random.default_rng(6)
    check_real(pad_not_edge(xyb[:, :2160, :3833], rng), inv1, p2,
               "4k crop 2160x3833, pad rows not edge copies")
    dev = xyb.device
    for h, w in ((1, 1), (3, 5), (7, 2), (13, 21), (70, 131)):
        x = torch.from_numpy(rng.uniform(-0.05, 0.6, (3, h, w))
                             .astype(np.float32)).to(dev)
        # 70x131: the slopes a column slice of a wider map (row stride 20)
        nb = (-(-h // 8), -(-w // 8) + (3 if h == 70 else 0))
        sig = torch.from_numpy(rng.uniform(0.0, 2.5, nb).astype(np.float32))
        inv = filters.epf_inv(sig.to(dev), 1.0)[:, :-(-w // 8)]
        check_real(pad_not_edge(x, rng), inv, 6.5,
                   f"{h}x{w}, pad rows not edge copies")
    return counts


def legacy_timings(dev, card: str, ms: dict) -> None:
    """Device ms at 4K of the round-1 reconstruct_srgb8 / reconstruct_u16
    and of kernels 5 and 6 on each route (the pipeline's per-block quant
    field with u8, u16 or f32 out; the JAX entry points' per-pixel map),
    each against its twin and its bound.  The kernel calls are timed by
    replaying a CUDA graph of 50 calls; the twins and the whole
    reconstruction copy from the host and cannot be captured."""
    ac, dc, qf = codec.quantize_still(bench_frame(2160, 3840), 1.0, dev)
    ny, nx = qf.shape
    tiles = (-(-ny // 8), -(-nx // 8))
    args = (ac.to(torch.int16), dc, qf,
            torch.zeros(tiles, dtype=torch.int32, device=dev),
            torch.full(tiles, 64, dtype=torch.int32, device=dev), 1.0)
    for fn, k in ((LP.reconstruct_srgb8, 6), (LP.reconstruct_u16, 5)):
        print(f"legacy {fn.__name__} at 4k (dequant, IDCT, kernel {k}): "
              f"device {device_ms(lambda: fn(*args)):.3f} ms [{card}]",
              flush=True)
    fx, fb = LP.expand_cfl(args[3], args[4], ny, nx)
    img = LP.dequant_idct(args[0], dc, qf, fx, fb, 1.0)
    px = img.shape[1] * img.shape[2]
    filt = px * (OPS_PX["gaborish"] + OPS_PX["epf2"])
    codes = filt + px * OPS_PX["codes"]
    inv = LP.inv_sigma_map(qf, 1.0)
    padded, inv_p = LP.pad_rows(img, FF.PAD), LP.pad_rows(inv, FF.PAD)
    stacked = torch.cat([padded, inv_p[None]])
    routes = {  # bound name: (bytes moved, f32 ops, kernel, twin)
        "fused_filters2": (
            nbytes(img, qf) + 3 * px, codes,
            lambda: FF.legacy_filters(img, qf, 1.0, True, True, "u8"),
            lambda: FF.legacy_filters_plain(img, qf, 1.0, True, True, "u8")),
        "fused_gab_epf": (
            nbytes(img, qf) + 6 * px, codes,
            lambda: FF.legacy_filters(img, qf, 1.0, True, True, "u16"),
            lambda: FF.legacy_filters_plain(img, qf, 1.0, True, True, "u16")),
        "fused_gab_epf f32": (
            2 * nbytes(img) + nbytes(qf), filt,
            lambda: FF.legacy_filters(img, qf, 1.0, True, True, "f32"),
            lambda: FF.legacy_filters_plain(img, qf, 1.0, True, True, "f32")),
        "fused_gab_epf(stacked)": (
            2 * nbytes(img) + nbytes(inv), filt,
            lambda: FF.fused_gab_epf(stacked),
            lambda: FF.fused_gab_epf_plain(stacked)),
        "fused_filters2(padded, to_srgb)": (
            nbytes(img, inv) + 3 * px, codes,
            lambda: FF.fused_filters2(padded, inv_p, True),
            lambda: FF.fused_filters2_plain(padded, inv_p, True)),
    }
    for name, (moved, ops, kern, twin) in routes.items():
        note_bound(name, moved, ops)
        t = (graph_ms(kern), device_ms(twin))
        if name in KERNELS:
            ms[name] = t
        print(f"kernel {name} at 4k: device {t[0]:.4f} ms (CUDA graph), "
              f"plain twin {t[1]:.3f} ms, bound {BOUND[name][0]:.4f} ms "
              f"[{card}]", flush=True)


def fused_timings(xyb, sigma, cfg, card: str, ms: dict) -> None:
    """Phase 9: device ms at 4K of kernels 3 and 4 by replaying a CUDA
    graph of 50 calls, against their twins (CUDA events) and against
    kernel 2's tile pass at the same epf_iters, timed both ways."""
    xp = LP.pad_rows(xyb, FF.PAD)
    inv1 = filters.epf_inv(sigma, 1.0)
    p2 = cfg.pass2_scale
    gabw = (FF.DEFAULT_GW1, FF.DEFAULT_GW2) * 3
    px = xyb.shape[1] * xyb.shape[2]
    gab_epf1 = px * (OPS_PX["gaborish"] + OPS_PX["epf1"] + OPS_PX["srgb"])
    note_bound("fused_real_filters", nbytes(xp, inv1) + 3 * px,
               gab_epf1 + px * OPS_PX["epf2"])
    note_bound("fused_real_gab_epf1", nbytes(xp, inv1) + 3 * px, gab_epf1)
    for name, it, kind in REAL_CASES:
        if kind == "u16":
            continue
        call, twin = real_call(name, it, kind), real_call(name, it, kind, True)
        t = (graph_ms(lambda: call(xp, inv1, p2)),
             device_ms(lambda: twin(xp, inv1, p2)))
        if kind == "u8" and (name, it) in (("fused_real_filters", 2),
                                           ("fused_real_gab_epf1", 1)):
            ms[name] = t
        print(f"kernel {name} at 4k epf_iters {it} {kind}: device "
              f"{t[0]:.4f} ms (CUDA graph), plain twin {t[1]:.3f} ms, bound "
              f"{BOUND[name][0]:.4f} ms [{card}]", flush=True)
    for it in (1, 2):
        def chain():
            return filters.restore_and_output(xyb, sigma, True, it, gabw,
                                              cfg.pass0_scale, p2, "u8")
        print(f"kernel 2 (restore_and_output) at 4k epf_iters {it} u8: device "
              f"{graph_ms(chain):.4f} ms (CUDA graph), {device_ms(chain):.4f} ms "
              f"(CUDA events, the method kernels 3 and 4 had) [{card}]",
              flush=True)


def within_one_code(got: np.ndarray, ref: np.ndarray, what: str) -> None:
    """A decoded frame within 1 code on < 0.1% of values."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {got.shape} {got.dtype} vs "
                             f"{ref.shape} {ref.dtype}")
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    frac = float((d > 0).mean())
    print(f"{what}: max {d.max()} code, differing share {frac:.3g}",
          flush=True)
    if d.max() > 1 or frac >= 1e-3:
        raise AssertionError(f"{what}: outside 1 code / 0.1%")


def check_detile(src: torch.Tensor, ny: int, nx: int, rows, label: str) -> None:
    """Kernel 7 bit-equal to its plain version."""
    got = DT.detile(src, ny, nx, rows)
    ref = DT.detile_plain(src, ny, nx, rows)
    if got.shape != ref.shape or not torch.equal(got, ref):
        raise AssertionError(f"detile differs from its plain version ({label})")
    note_err("detile", (got - ref).abs().max().item(), 0.0, label)


def dct8_phase(dev, card: str, ms: dict) -> dict:
    """Phase 10: the DCT8-only frame path and kernel 7."""
    # kernel 7 at the research probe's shape: 140,000 source rows, a
    # seeded permutation subset of 270 x 480 of them
    rng = np.random.default_rng(0)
    ny, nx, n_src = 270, 480, 140000
    src = torch.from_numpy(rng.standard_normal((n_src, 192))
                           .astype(np.float32)).to(dev)
    perm = torch.from_numpy(rng.permutation(n_src)[:ny * nx]
                            .astype(np.int32)).to(dev)
    check_detile(src, ny, nx, perm, "probe shape, 140000 rows, permutation")
    print(f"kernel detile at the probe shape (permutation subset): device "
          f"{device_ms(lambda: DT.detile(src, ny, nx, perm)):.3f} ms, plain "
          f"{device_ms(lambda: DT.detile_plain(src, ny, nx, perm)):.3f} ms "
          f"[{card}]", flush=True)
    del src, perm

    # the 4K all-DCT8 stream: the repo's host encoder at effort 2
    img = bench_frame(2160, 3840)
    data = stream(img, 1.0, 2)
    args, (gab, epf_iters, skip) = dct8.arguments(data)
    print(f"dct8 4k_d1.0_e2: {len(data)} bytes, gab {gab} epf_iters "
          f"{epf_iters} skip_dc_smooth {skip}", flush=True)
    state = dct8.to_device(*args, dev)
    frame = dct8.DCT8Frame(gab, epf_iters, skip)
    out, counts = drive("DCT8 path (DCT8Frame at 4K)", lambda: frame(state),
                        ("detile", "restore_and_output"))
    if counts["restore_and_output"] != 1:
        raise AssertionError(f"DCT8Frame launched kernel 2 "
                             f"{counts['restore_and_output']} times, not once")
    got = out.cpu().numpy()
    within_one_code(got, frame(dct8.to_device(*args, "cpu")).numpy(),
                    "dct8 4k_d1.0_e2 vs the port's CPU path")
    within_one_code(got, reference.decode_float64(data),
                    "dct8 4k_d1.0_e2 vs the float64 host decoder")

    # a ragged all-DCT8 frame (65 x 97 blocks, the image 517 x 771)
    rdata = stream(bench_frame(517, 771), 1.0, 2)
    rargs, rflt = dct8.arguments(rdata)
    rframe = dct8.DCT8Frame(*rflt)
    within_one_code(rframe(dct8.to_device(*rargs, dev)).cpu().numpy(),
                    rframe(dct8.to_device(*rargs, "cpu")).numpy(),
                    "dct8 ragged 517x771 (520x776 block grid) vs the "
                    "port's CPU path")

    # kernel 7 at the path's own 4K identity: the tiles the IDCT gives
    co, dcs, qf, _sh, xf, bf, tab = (state[k] for k in dct8._TENSORS)
    steps = dct8.dc_steps(state["igs"], state["quant_dc"], state["dcq"])
    dcp = dct8.dc_xyb_planes(dcs, steps)
    if not skip:
        dcp = dct8.dc_smoothing(dcp, steps)
    tiles = dct8.synth_tiles(co, dcp, qf, xf, bf, tab, state["igs"],
                             state["qm_x"], state["qm_b"])
    ys, xs = qf.shape
    check_detile(tiles, ys, xs, None, "4k DCT8 identity")
    note_bound("detile", 2 * nbytes(tiles), 0)
    ms["detile"] = (device_ms(lambda: DT.detile(tiles, ys, xs)),
                    device_ms(lambda: DT.detile_plain(tiles, ys, xs)))
    # one PyTorch call for the same function: the permuted copy
    LIBRARY_MS["detile"] = device_ms(lambda: tiles.view(
        ys, xs, 3, 8, 8).permute(2, 0, 3, 1, 4).contiguous())
    print(f"kernel detile at 4k (identity): device {ms['detile'][0]:.4f} ms, "
          f"plain {ms['detile'][1]:.4f} ms, permute().contiguous() "
          f"{LIBRARY_MS['detile']:.4f} ms, bound {BOUND['detile'][0]:.4f} ms "
          f"[{card}]", flush=True)

    # DCT8Frame's device time at 4K, whole and by stage
    planes = DT.detile(tiles, ys, xs)
    stacked = torch.randn((ys * xs, 3, 64), device=dev)
    kron = dct8._kron_basis(dev)
    # the stages in the path's order; their sum is the path's device-busy
    # time (the whole frame's many small launches leave it host-bound)
    stages = {
        "dc planes + smoothing": lambda: dct8.dc_smoothing(
            dct8.dc_xyb_planes(dcs, steps), steps),
        "dequant + CfL + IDCT product + DC": lambda: dct8.synth_tiles(
            co, dcp, qf, xf, bf, tab, state["igs"], state["qm_x"],
            state["qm_b"]),
        "kernel 7 (detile)": lambda: DT.detile(tiles, ys, xs),
        "filters + sRGB8 (kernel 2's tile pass, with the sigma map)":
            lambda: dct8.filter_and_output(planes, qf, state["sharp"],
                                           state["igs"], gab, epf_iters),
    }
    busy = 0.0
    for what, fn in stages.items():
        t = device_ms(fn)
        busy += t
        print(f"  dct8 4k {what}: device {t:.3f} ms [{card}]", flush=True)
    print(f"  dct8 4k IDCT product alone: device "
          f"{device_ms(lambda: dct8._fp32_matmul(stacked, kron)):.3f} ms "
          f"[{card}]", flush=True)
    mp = 8 * ys * 8 * xs / 1e6
    whole = device_ms(lambda: frame(state))
    print(f"stage dct8 4k (DCT8Frame, inputs resident): device busy "
          f"{busy:.3f} ms (sum of its stages) = {mp / busy * 1e3:.1f} MP/s; "
          f"whole frame back to back {whole:.3f} ms [{card}]", flush=True)
    return counts


def ptxas_report(name: str, log=None, tag: str = "",
                 only: str = "") -> None:
    """Registers, shared memory, stack and spills of each kernel of
    csrc/<name>.cu, from ptxas's report in the build log (this tree's, or
    `log`, another build's, printed with `tag`), by kernel and template
    arguments (demangled where c++filt is installed); `only`: the kernels
    whose name holds it."""
    rows, kern, spill = [], None, ""
    log = log or _build.library_path(name).with_suffix(".log")
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            kern = line.split("'")[1]
        elif "spill stores" in line and kern:
            spill = line.strip()
        elif "Used" in line and "registers" in line and kern:
            rows.append((kern, line.split(":", 1)[1].strip(), spill))
            kern = None
    names = [r[0] for r in rows]
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    for name_, (_, used, spill) in zip(names, rows):
        kernel = name_.replace("(anonymous namespace)::", "").split("(")[0]
        kernel = kernel.removeprefix("void ")
        if only in kernel:
            print(f"ptxas {tag}{name}.cu {kernel}: {used}; {spill}",
                  flush=True)


def synthesized(cfg, inp):
    """The frame's synthesised (3, H8, W8) planes and its sigma map."""
    planes = torch.zeros((3, cfg.H8, cfg.W8), device=inp.dc.device)
    for fam in inp.families:
        synth.synth_family(planes, fam, inp.dc, inp.qm)
    return planes, filters.sigma_map(inp.sharp, inp.qf, inp.igs)


def chain_ops(gab: bool, epf_iters: int) -> int:
    """The least f32 operations per pixel of the chain and the output."""
    return (OPS_PX["gaborish"] * gab + OPS_PX["epf0"] * (epf_iters >= 3)
            + OPS_PX["epf1"] * (epf_iters >= 1)
            + OPS_PX["epf2"] * (epf_iters >= 2) + OPS_PX["srgb"])


def synth_bound(name: str, fams, dc) -> None:
    """The DC image, each family's row index (bys: padding rows are found
    by reading it), matrices and exception list, and the coefficients and
    per-row scalars of its live rows in; the live rows' pixels out.  A
    separable IDCT of bh x bw is bh*bw*(bh+bw) MACs per channel (a special
    family's response product 64 x 64), plus dequant and CfL (4 ops per
    coefficient), per live row."""
    moved = nbytes(dc)
    ops = 0
    for f in fams:
        n = int((f.bys != inputs._PAD_SENTINEL).sum().item())
        moved += nbytes(*[t for t in (f.bys, f.tab, f.resp, f.resp_y_def,
                                      f.fix_idx, f.fix_val) if t is not None])
        moved += n * sum(t[0].numel() * t.element_size() for t in (
            f.coef, f.bxs, f.inv_qac, f.xf, f.bf))
        moved += n * 3 * f.bh * f.bw * 4
        ops += n * 3 * (
            2 * 64 * 64 if f.special else 2 * f.bh * f.bw * (f.bh + f.bw)
            + 4 * f.bh * f.bw)
    note_bound(name, moved, ops)


def synth_timings(cfg, inp, planes, card: str, ms: dict) -> None:
    """Device ms of each family's synthesis at 4K (the DCT8 kernel and
    the general kernel apart) against the plain twin, and of the whole."""
    fams = inp.families
    per = {}
    for f in fams:
        per[f.sid] = (device_ms(lambda: synth.synth_family(planes, f, inp.dc, inp.qm)),
                      device_ms(lambda: synth.synth_family_plain(planes, f, inp.dc, inp.qm)))
        n = int((f.bys != inputs._PAD_SENTINEL).sum().item())
        print(f"kernel {synth_kernel(f)} at 4k, family sid {f.sid} ({n} of "
              f"{int(f.coef.shape[0])} rows, {str(f.coef.dtype)[6:]}): device "
              f"{per[f.sid][0]:.4f} ms, plain {per[f.sid][1]:.3f} ms [{card}]",
              flush=True)
    for f in fams:
        if synth.is_dct8(f):
            # the DCT8 family's IDCT as the fp32 torch.matmul pair (TF32
            # off) on its blocks' coefficients: the transform alone
            valid = f.bys != inputs._PAD_SENTINEL
            coef = synth.coefficients(f)[valid].to(torch.float32).reshape(
                -1, 3, 8, 8).contiguous()
            n = coef.shape[0]
            basis = synth._basis(8, planes.device)
            LIBRARY_MS["synth_dct8"] = graph_ms(
                lambda: basis.t() @ (coef @ basis))
            print(f"synth_dct8 yardstick: the fp32 matmul pair on {n} DCT8 "
                  f"blocks {LIBRARY_MS['synth_dct8']:.4f} ms [{card}]",
                  flush=True)
    for k in ("synth_dct8", "synth_family"):
        mine = [f for f in fams if synth_kernel(f) == k]
        synth_bound(k, mine, inp.dc)
        ms[k] = (sum(per[f.sid][0] for f in mine),
                 sum(per[f.sid][1] for f in mine))
    synth_bound("synthesis", fams, inp.dc)
    whole = device_ms(lambda: [synth.synth_family(planes, f, inp.dc, inp.qm)
                               for f in fams])
    print(f"synthesis at 4k, all {len(fams)} families: device {whole:.4f} ms, "
          f"bound {BOUND['synthesis'][0]:.4f} ms [{card}]", flush=True)


def fhd_timings(data: bytes, dev, card: str, ms: dict) -> None:
    """Kernel 2 at epf_iters 3 (two launches) and its EPF0 pass on the FHD
    d4.0 stream's synthesised planes, with the bounds EPF passes 0 and 2
    would have as launches of their own (each reading and writing three
    f32 planes)."""
    cfg, inp = prepared(data, dev)
    planes, sigma = synthesized(cfg, inp)
    xyb = planes[:, :cfg.crop_h, :cfg.crop_w]
    px = cfg.crop_h * cfg.crop_w
    args = (xyb, sigma, cfg.gab, cfg.epf_iters, cfg.gabw, cfg.pass0_scale,
            cfg.pass2_scale, "u8")
    note_bound("restore_and_output fhd", nbytes(xyb, sigma) + 3 * px,
               px * chain_ops(cfg.gab, cfg.epf_iters))
    t = (graph_ms(lambda: filters.restore_and_output(*args)),
         device_ms(lambda: filters.restore_and_output_plain(*args)))
    print(f"kernel restore_and_output at fhd epf_iters {cfg.epf_iters} u8 "
          f"(two launches): device {t[0]:.4f} ms (CUDA graph), plain "
          f"{t[1]:.3f} ms, bound "
          f"{BOUND['restore_and_output fhd'][0]:.4f} ms [{card}]", flush=True)
    e0 = (xyb, sigma, cfg.gab, cfg.gabw, cfg.pass0_scale)
    note_bound("epf0_pass", 2 * nbytes(xyb) + nbytes(sigma),
               px * (OPS_PX["gaborish"] * cfg.gab + OPS_PX["epf0"]))
    ms["epf0_pass"] = (graph_ms(lambda: filters.epf0_pass(*e0)),
                       device_ms(lambda: filters.epf0_pass_plain(*e0)))
    print(f"kernel epf0_pass at fhd (gaborish + EPF0, f32 out): device "
          f"{ms['epf0_pass'][0]:.4f} ms (CUDA graph), plain {ms['epf0_pass'][1]:.3f} ms, "
          f"bound {BOUND['epf0_pass'][0]:.4f} ms [{card}]", flush=True)
    for p in (0, 2):
        note_bound(f"EPF pass {p} as a launch of its own at fhd",
                   2 * nbytes(xyb) + nbytes(sigma), px * OPS_PX[f"epf{p}"])


# the layers of api.decode: layer -> the port's functions in module api
# that make it (the device half and d2h are wrapped apart)
DECODE_LAYERS = {"parse": ("_read_frames", "parse_frame"), "pack": ("pack",),
                 "h2d": ("from_prepared",),
                 "rest": ("apply_orientation", "basic_info")}
# the host parse's own steps: step -> the functions vardct/parse.py's
# parse_frame calls for it
PARSE_STEPS = {"LF global": ("read_lf_global",),
               "LF groups": ("read_lf_group",),
               "HF global": ("read_hf_global",),
               "DC planes + smoothing": ("compute_dc_planes",
                                         "adaptive_dc_smoothing"),
               "pass groups (C++)": ("read_pass_group",),
               "BlockArrays.concat": ("concat",)}
# the device route's own steps (entropy="device"): step -> the functions of
# entropy/device.py that parse_frame calls for it; the kernel's wrapper
# synchronises, so that its launch ends inside it
ENTROPY_STEPS = {"anchors": ("build_anchors",),
                 "upload": ("group_streams", "frame_tables"),
                 "kernel": ("decode_pass_groups",),
                 "status read": ("check_groups",)}


def timed(fn, name: str, log: list, sync: bool = False):
    """fn, appending (name, start, end) on the host clock to log per call
    (the pass groups' calls append from a thread pool); with sync, the
    call ends with torch.cuda.synchronize().  The wrapper carries fn's
    attributes (a kernel wrapper's launch count)."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            return out
        finally:
            log.append((name, t0, time.perf_counter()))
    return call


class Pixels:
    """A decode's pixels on the card whose .cpu().numpy() logs its span
    as "d2h"."""

    def __init__(self, px, log: list):
        self.px, self.log = px, log

    def cpu(self):
        t0 = time.perf_counter()
        host = self.px.cpu()
        log = self.log

        class Host:
            def numpy(self):
                out = host.numpy()
                log.append(("d2h", t0, time.perf_counter()))
                return out
        return Host()


@contextlib.contextmanager
def split_decode(log: list):
    """Wrap the port's functions that api.decode calls, and the host
    parse's steps, so that each call logs its span; restore them on exit.
    The device half is VarDCTFrame(cfg)(inputs) followed by
    torch.cuda.synchronize() in the wrapper, so that its kernels end
    inside it; d2h is the pixels' .cpu().numpy()."""
    saved = []

    def wrap(owner, name, wrapper):
        saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, wrapper)

    for names in DECODE_LAYERS.values():
        for name in names:
            wrap(api, name, timed(getattr(api, name), name, log))
    for names in PARSE_STEPS.values():
        for name in names:
            if name != "concat":
                wrap(PARSE, name, timed(getattr(PARSE, name), name, log))
    wrap(BlockArrays, "concat",
         staticmethod(timed(BlockArrays.concat, "concat", log)))
    for names in ENTROPY_STEPS.values():
        for name in names:
            wrap(ENT, name, timed(getattr(ENT, name), name, log,
                                  sync=name == "decode_pass_groups"))
    wrap(inputs, "_gather_family",
         timed(inputs._gather_family, "_gather_family", log, sync=True))

    class Frame:
        def __init__(self, cfg):
            self.cfg = cfg

        def __call__(self, frame_inputs):
            t0 = time.perf_counter()
            px = VarDCTFrame(self.cfg)(frame_inputs)
            torch.cuda.synchronize()
            log.append(("device", t0, time.perf_counter()))
            return Pixels(px, log)

    wrap(api, "VarDCTFrame", Frame)
    try:
        yield
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


@contextlib.contextmanager
def no_gc():
    """The cyclic garbage collector off for one timed call (as timeit runs
    its calls), after a collection, so that a collection triggered by
    earlier allocations does not land inside one call's layers."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def spent(log: list, names) -> float:
    """Milliseconds summed over the logged calls of `names`."""
    return sum(t1 - t0 for n, t0, t1 in log if n in names) * 1e3


def decode_layers(data: bytes, mp: float, card: str, runs: int = 3) -> dict:
    """M1, for both entropy routes: the 4K decode split into its layers
    inside the same api.decode calls whose total is printed, `runs` of
    them per route in turns with as many unwrapped calls (split first in
    even pairs, unsplit first in odd ones; the routes alternate call by
    call); raises if a split call's layers do not sum to within 2% of its
    own total.  Then the parse by its own steps, from the same calls.  The
    garbage collector is off during each timed call (no_gc).  Returns each
    route's medians by layer and step (ms)."""
    routes = ("host", "device")
    split = {r: [] for r in routes}
    unsplit = {r: [] for r in routes}
    for i in range(2 * runs):
        for r in routes:
            torch.cuda.synchronize()
            if (i % 2 == 0) == (i // 2 % 2 == 0):
                log = []
                with split_decode(log), no_gc():
                    t0 = time.perf_counter()
                    api.decode(data, device="cuda", entropy=r)
                    split[r].append(((time.perf_counter() - t0) * 1e3, log))
            else:
                with no_gc():
                    t0 = time.perf_counter()
                    api.decode(data, device="cuda", entropy=r)
                    unsplit[r].append((time.perf_counter() - t0) * 1e3)
    return {r: report_layers(r, split[r], unsplit[r], mp, card, runs)
            for r in routes}


def report_layers(route: str, split: list, unsplit: list, mp: float,
                  card: str, runs: int) -> dict:
    """One route's lines of decode_layers; its medians by name."""
    med = statistics.median
    layers = {**DECODE_LAYERS, "device": ("device",), "d2h": ("d2h",)}
    per = {k: [spent(log, names) for _, log in split]
           for k, names in layers.items()}
    sums = [sum(v[n] for v in per.values()) for n in range(len(split))]
    gaps = [abs(sums[n] - total) / total for n, (total, _) in enumerate(split)]
    for n, (total, _log) in enumerate(split):
        if gaps[n] > 0.02:
            raise AssertionError(f"split decode {n} ({route}): its layers sum "
                                 f"to {sums[n]:.1f} ms, the call took "
                                 f"{total:.1f} ms")
    m = {k: med(v) for k, v in per.items()}
    t_split, t_unsplit = med(t for t, _ in split), med(unsplit)
    print(f"layers 4k entropy={route} (host clock, ms, median of {runs} split "
          f"api.decode calls): parse (_read_frames + parse_frame) "
          f"{m['parse']:.1f}, pack {m['pack']:.1f}, h2d (from_prepared) "
          f"{m['h2d']:.1f}, device (VarDCTFrame(cfg)(inputs), then "
          f"torch.cuda.synchronize() in the wrapper) {m['device']:.1f}, d2h "
          f"(.cpu().numpy()) {m['d2h']:.1f}, rest (apply_orientation, "
          f"basic_info) {m['rest']:.1f}; sum of the medians "
          f"{sum(m.values()):.1f}; each call's layers summed, median "
          f"{med(sums):.1f}, within {max(gaps):.2%} of the call's own total; "
          f"the split calls' total {t_split:.1f}; unsplit calls "
          f"{t_unsplit:.1f} (split - unsplit {t_split - t_unsplit:+.1f} ms: "
          f"the wrappers' cost and the spread) [{card}]", flush=True)
    print(f"end_to_end 4k decode entropy={route} bytes->pixels (the unsplit "
          f"calls): {t_unsplit:.1f} ms = {mp / t_unsplit * 1e3:.2f} MP/s "
          f"[{card}]", flush=True)

    # the parse by its own steps; the host route's pass groups run on a
    # thread pool, so their wall span (first call's start to last call's
    # end) and their time summed over the threads apart
    steps = {s: [spent(log, names) for _, log in split]
             for s, names in {**PARSE_STEPS, **ENTROPY_STEPS}.items()}
    pg = "pass groups (C++)"
    wall, calls = [], []
    for _, log in split:
        spans = [(t0, t1) for n, t0, t1 in log if n == "read_pass_group"]
        wall.append((max(t1 for _, t1 in spans) - min(t0 for t0, _ in spans))
                    * 1e3 if spans else 0.0)
        calls.append(len(spans))
    read_frame = [spent(log, ("_read_frames",)) for _, log in split]
    rest = [spent(log, ("parse_frame",)) - wall[n]
            - sum(v[n] for s, v in steps.items() if s != pg)
            for n, (_, log) in enumerate(split)]
    gather = [spent(log, ("_gather_family",)) for _, log in split]
    shown = [s for s in steps if med(steps[s]) > 0 or s in PARSE_STEPS]
    if route == "host":
        shown = [s for s in shown if s in PARSE_STEPS]
    print(f"parse 4k entropy={route} by step (host clock, ms, median of the "
          f"same {runs} calls): _read_frames {med(read_frame):.1f}, "
          + ", ".join(f"{s} {med(steps[s]):.1f}" for s in shown
                      if s not in (pg, "BlockArrays.concat"))
          + (f", {pg} {med(wall):.1f} wall ({calls[0]} calls on "
             f"{os.cpu_count()} cores; {med(steps[pg]):.1f} summed over the "
             f"threads), BlockArrays.concat "
             f"{med(steps['BlockArrays.concat']):.1f}" if route == "host"
             else "")
          + f", the rest of parse_frame {med(rest):.1f}; then pack "
          f"{m['pack']:.1f}"
          + (f" (of it the family gather on the card, synchronised, "
             f"{med(gather):.1f})" if route == "device" else "")
          + f" [{card}]", flush=True)
    out = dict(m, total=t_unsplit, family_gather=med(gather),
               pass_groups_wall=med(wall))
    out.update({s: med(v) for s, v in steps.items()})
    return out


# ---- the device entropy decode (entropy="device") ----

def entropy_run(data: bytes, dev):
    """api.prepare(data, dev, entropy="device") with the decode's tables
    and its output recorded -> (Tables, Decoded)."""
    seen = {}
    frame_tables, check_groups = ENT.frame_tables, ENT.check_groups

    def tables(*args):
        seen["tables"] = frame_tables(*args)
        return seen["tables"]

    def check(decoded):
        seen["decoded"] = decoded
        return check_groups(decoded)

    ENT.frame_tables, ENT.check_groups = tables, check
    try:
        api.prepare(data, dev, entropy="device")
    finally:
        ENT.frame_tables, ENT.check_groups = frame_tables, check_groups
    return seen["tables"], seen["decoded"]


def twin_job(tables: tuple):
    """In a worker process: the twin on the CPU -> (coefficients, status,
    final states, tokens as numpy, seconds)."""
    torch.set_num_threads(1)
    t = ENT.Tables(*[torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                     for x in tables])
    t0 = time.perf_counter()
    d = ENT.decode_pass_groups_plain(t)
    return tuple(x.numpy() for x in d) + (time.perf_counter() - t0,)


def start_twins(pool, streams: dict, dev) -> dict:
    """The kernel on each of `streams` (label -> data), its output kept,
    and the twin on the same tables started in `pool`."""
    jobs = {}
    for label, data in streams.items():
        tables, dec = entropy_run(data, dev)
        host = tuple(x.cpu().numpy() if isinstance(x, torch.Tensor) else x
                     for x in tables)
        jobs[label] = (tuple(x.cpu().numpy() for x in dec),
                       pool.apply_async(twin_job, (host,)))
    return jobs


def check_twins(jobs: dict) -> float:
    """Kernel against twin on each stream: 0 coefficients may differ, and
    the status bits, final rANS states and token counts must be equal.
    Returns the twin's seconds by stream."""
    seconds = {}
    for label, (kernel, job) in jobs.items():
        twin = job.get()
        differ = int((kernel[0] != twin[0]).sum())
        same = all(np.array_equal(a, b) for a, b in zip(kernel[1:], twin[1:4]))
        note_err("decode_pass_groups", np.abs(
            kernel[0].astype(np.int64) - twin[0].astype(np.int64)).max(
                initial=0), 0,
            f"{label}: {differ} of {kernel[0].size} coefficients differ, "
            f"status / final states / tokens {'equal' if same else 'DIFFER'}"
            f" ({len(kernel[1])} groups, {int(kernel[3].max())} tokens in the "
            f"longest; the twin on the CPU {twin[4]:.1f} s)")
        if not same:
            raise AssertionError(f"decode_pass_groups: the kernel's status, "
                                 f"states or tokens differ from the twin's "
                                 f"on {label}")
        seconds[label] = twin[4]
    return seconds


def entropy_main_path(streams: dict, outs: dict) -> int:
    """The main path with entropy="device", counted: one kernel launch per
    frame, no host read_pass_group, and the pixels of the host route
    (phase 5's `outs`), exactly."""
    reads = []
    read = PARSE.read_pass_group

    def read_pass_group(*args, **kwargs):
        reads.append(1)
        return read(*args, **kwargs)

    def main_path():
        got, per_frame = {}, {}
        for label, (_h, _w, data) in streams.items():
            before = ENT.decode_pass_groups.launches
            got[label] = api.decode(data, device="cuda", entropy="device")[0]
            per_frame[label] = ENT.decode_pass_groups.launches - before
        return got, per_frame

    PARSE.read_pass_group = read_pass_group
    try:
        (got, per_frame), counts = drive(
            "main path (api.decode, entropy=device)", main_path,
            ("decode_pass_groups",))
    finally:
        PARSE.read_pass_group = read
    if reads:
        raise AssertionError(f"entropy=device read {len(reads)} pass groups "
                             f"on the host")
    for label, n in per_frame.items():
        d = np.abs(got[label].astype(np.int64) - outs[label].astype(np.int64))
        print(f"decode {label} entropy=device: {n} launch of "
              f"decode_pass_groups, no host pass group; pixels against "
              f"entropy=host max {d.max()} code", flush=True)
        if n != 1 or d.max() != 0:
            raise AssertionError(f"{label}: {n} launches, pixels {d.max()} "
                                 f"codes from the host route's")
    return counts["decode_pass_groups"]


def entropy_4k(data: bytes, dev, card: str, ms: dict, twin: tuple,
               layers: dict) -> None:
    """At 4K: the kernel's coefficients against the host route's
    BlockArrays.concat(...).coeffs, bit for bit; its time by CUDA events
    around 10 launches, tokens per group and its bound, beside the host
    route's pass groups and the device route's own steps from M1's
    calls."""
    cs, hdr, fh, toc = api._read_frame(data)
    host = PARSE.parse_frame(cs, hdr, fh, toc)["blocks_glob"].coeffs
    tables, dec = entropy_run(data, dev)
    differ = int((dec.coeffs.cpu().numpy() != host).sum())
    print(f"kernel decode_pass_groups at 4k against the host route's "
          f"BlockArrays.concat(...).coeffs: {differ} of {host.size} "
          f"coefficients differ", flush=True)
    if differ or dec.coeffs.numel() != host.size:
        raise AssertionError("decode_pass_groups disagrees with the host "
                             "decoder at 4K")
    # the instantiation that reads the pass tables from global memory
    # (tables larger than the kernel stages in shared memory)
    big = ENT.decode_pass_groups(tables._replace(stage_words=1 << 30))
    differ = int((big.coeffs != dec.coeffs).sum().item())
    print(f"kernel decode_pass_groups at 4k with its tables in global memory:"
          f" {differ} of {host.size} coefficients differ from the staged "
          f"launch", flush=True)
    if differ or not torch.equal(big.states, dec.states):
        raise AssertionError("the global-table instantiation disagrees")
    tokens = dec.tokens.cpu().numpy()
    ENT.decode_pass_groups(tables)
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(REPS):
        ENT.decode_pass_groups(tables)
    e.record()
    e.synchronize()
    kernel_ms = s.elapsed_time(e) / REPS
    # the twin runs on a smaller stream (twin: its label, bytes, seconds):
    # the kernel is timed there too
    twin_label, twin_data, twin_s = twin
    small_tables, _ = entropy_run(twin_data, dev)
    small_ms = cuda_ms(lambda: ENT.decode_pass_groups(small_tables))
    ms["decode_pass_groups"] = (kernel_ms, twin_s * 1e3)
    global_ms = cuda_ms(lambda: ENT.decode_pass_groups(
        tables._replace(stage_words=1 << 30)))
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    chain_ms = int(tokens.max()) * CHAIN_CYCLES / (clock * 1e3)
    # the codestream and the tables read once, the coefficients (and the
    # small status vectors) written once
    moved = nbytes(*[x for x in tables if isinstance(x, torch.Tensor)],
                   *dec)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    BOUND["decode_pass_groups"] = ((chain_ms, "operations")
                                   if chain_ms >= bytes_ms
                                   else (bytes_ms, "bytes"))
    print(f"bound decode_pass_groups at 4k: the longest group's "
          f"{int(tokens.max())} tokens x {CHAIN_CYCLES} cycles at "
          f"{clock:.0f} MHz = {chain_ms:.4f} ms; {moved / 1e6:.1f} MB at "
          f"3.35 TB/s = {bytes_ms:.4f} ms", flush=True)
    host_wall = layers["host"]["pass_groups_wall"]
    print(f"kernel decode_pass_groups at 4k ({len(tokens)} groups, one launch"
          f" with the output's zero fill): {kernel_ms:.3f} ms (CUDA events "
          f"around {REPS} launches) = {kernel_ms * 1e6 / tokens.max():.1f} ns "
          f"per token of the longest group (tables in global memory "
          f"{global_ms:.3f} ms); tokens per group max "
          f"{int(tokens.max())}, mean {tokens.mean():.1f}; bound "
          f"{BOUND['decode_pass_groups'][0]:.4f} ms; plain twin (CPU, a "
          f"worker process) on {twin_label} {twin_s * 1e3:.1f} ms, the kernel"
          f" there {small_ms:.3f} ms; the host route's pass "
          f"groups in M1's calls {host_wall:.1f} ms wall; the device route's "
          f"anchors {layers['device']['anchors']:.1f} ms, upload "
          f"{layers['device']['upload']:.1f}, kernel + sync "
          f"{layers['device']['kernel']:.1f}, status read "
          f"{layers['device']['status read']:.1f}, family gather "
          f"{layers['device']['family_gather']:.1f}; end to end host "
          f"{layers['host']['total']:.1f} ms, device "
          f"{layers['device']['total']:.1f} ms [{card}]", flush=True)


# ---- the Modular decode (phase 11) ----

MODULAR_KERNELS = ("unsqueeze", "rct_inverse", "palette_inverse")
# what a Modular decode on the card must not run: the kernels' plain twins
# (the inverse transforms and kernel 2's XYB -> sRGB output)
MODULAR_TWINS = ((MDEV, ("unsqueeze_plain", "rct_inverse_plain",
                         "palette_inverse_plain")),
                 (filters, ("restore_and_output_plain",)),
                 (color, ("xyb_to_srgb_plain",)))
# the kernel that undoes each transform id (0 RCT, 1 palette, 2 squeeze)
TRANSFORM_KERNEL = {0: "rct_inverse", 1: "palette_inverse", 2: "unsqueeze"}
# the Modular fixture writers' sources: a change to any of them re-encodes
MODULAR_WRITER = [sys.modules[m].__file__ for m in (
    "port_fixtures", "jxl_coder_tpu_torch.host.codec",
    "jxl_coder_tpu_torch.host.modular.stream",
    "jxl_coder_tpu_torch.host.modular.transform")]
# the unsqueeze is one serial chain per line: its least time is the
# longest line's steps, each the least chain of dependent int32 operations
# from one step's carry `left` to the next's.  The averages and the
# residual are known ahead, so every term of them alone is off the chain,
# and so is 2 * left - 2 * a +- 1 (made while the division runs):
#   the tendency's numerator 4 * left + (6 - 3 * next - a)          1
#   its division by 12: multiply-high, shift, the sign's correction  3
#   the clamp to 2 * (left - a): x - (x & 1) > 2 (left - a) is
#     x > 2 (left - a) + 1, a compare and a select                   2
#   the clamp to the even 2 * (a - next): x + (x & 1) > it is x > it,
#     a compare and a select                                         2
#   the select of the monotonic branch, then of 0                    2
#   the residual's sum diff = r + tendency                           1
#   its half truncated: the sign bit added, the shift                2
#   the carry a + half - diff (a three-input add)                    1
# 14 (the rising branch's chain is as long and runs beside it), each at
# least Hopper's 4-cycle dependent-issue latency of an integer ALU
# instruction (published microbenchmarks), at the card's highest SM clock
UNSQUEEZE_STEP_CYCLES = 14 * 4


def rgba16_frame(h: int, w: int) -> np.ndarray:
    """bench_frame at 16 bits (x257, plus a seeded offset) with an alpha
    ramp."""
    rgb = bench_frame(h, w).astype(np.uint16) * 257 + 11
    alpha = (np.mgrid[0:h, 0:w][1] * 65535 // max(w - 1, 1)).astype(np.uint16)
    return np.concatenate([rgb, alpha[..., None]], -1)


# label: (the source image, how the port's fixture writers encode it)
MODULAR_STREAMS = {
    # the slice's full-size stream: 12 groups of 1024, RCT 6
    "4k_rct": (lambda: bench_frame(2160, 3840), modular_still),
    "4k_palette": (lambda: posterized_frame(2160, 3840),
                   lambda img: modular_still(img, palette=True)),
    "fhd_rgba16": (lambda: rgba16_frame(1080, 1920), modular_still),
    # one section, the largest the writer makes
    "1024_squeezed": (lambda: bench_frame(1024, 1024), squeezed_still),
    # 42 groups of 256, each with its own of the 42 RCT types
    "group_rct": (lambda: bench_frame(1536, 1792),
                  lambda img: group_rct_still(img, 1)),
    "xyb": (lambda: bench_frame(256, 384), xyb_still),
}


def modular_job(label: str):
    """In a worker process: the stream (encoded once per machine, cached)
    and its decode on the CPU route -> (bytes, pixels, seconds)."""
    torch.set_num_threads(1)
    make, write = MODULAR_STREAMS[label]
    img = make()
    data = cached(img, f"modular {label}", MODULAR_WRITER, lambda: write(img))
    t0 = time.perf_counter()
    pixels = api.decode(data, device="cpu")[0]
    return data, pixels, time.perf_counter() - t0


@contextlib.contextmanager
def modular_transforms_seen(seen: dict, current: list):
    """Record, per stream (current[0]), the transform ids whose undo runs,
    and the inputs of each undo (the channel tensors and the header)."""
    undo = MDEV.undo_transforms

    def recorded(image, header):
        seen.setdefault(current[0], []).append(
            ([c.data for c in image.channels], header))
        return undo(image, header)

    MDEV.undo_transforms = recorded
    try:
        yield
    finally:
        MDEV.undo_transforms = undo


MODULAR_PLAIN = {"unsqueeze": MDEV.unsqueeze_plain,
         "rct_inverse": MDEV.rct_inverse_plain,
         "palette_inverse": MDEV.palette_inverse_plain}


@contextlib.contextmanager
def twin_checked(calls: dict):
    """Each Modular kernel wrapper (and the unsqueeze's batched one, each
    channel of it) replaced by one that also runs the plain twin on the
    same inputs and records the largest difference; these launches compare
    and count nowhere."""
    saved = {k: getattr(MDEV, k) for k in MODULAR_KERNELS}

    def checked(k):
        def call(*args):
            got = saved[k](*args)
            ref = MODULAR_PLAIN[k](*args)
            d = ((got.long() - ref.long()).abs().max().item()
                 if got.shape == ref.shape and got.numel() else
                 (0 if got.shape == ref.shape else float("inf")))
            n, worst = calls.get(k, (0, 0))
            calls[k] = (n + 1, max(worst, d))
            return got
        call.launches = 0
        return call

    batch = MDEV.unsqueeze_batch

    def checked_batch(pairs):
        outs = batch(pairs)
        for (avg, res, horizontal), got in zip(pairs, outs):
            ref = MDEV.unsqueeze_plain(avg, res, horizontal)
            d = ((got.long() - ref.long()).abs().max().item()
                 if got.shape == ref.shape and got.numel() else
                 (0 if got.shape == ref.shape else float("inf")))
            n, worst = calls.get("unsqueeze", (0, 0))
            calls["unsqueeze"] = (n + 1, max(worst, d))
        return outs

    for k in MODULAR_KERNELS:
        setattr(MDEV, k, checked(k))
    MDEV.unsqueeze_batch = checked_batch
    try:
        yield
    finally:
        for k, f in saved.items():
            setattr(MDEV, k, f)
        MDEV.unsqueeze_batch = batch


def check_modular_seeded(dev) -> None:
    """Each kernel against its twin on seeded inputs, exactly: the
    unsqueeze on lines of length 1 to 70 both ways (odd lengths: nr < na)
    and near +-2^29; the inverse RCT over all 42 types with int32
    extremes; the palette with negative, in-range and over-range
    indices."""
    rng = np.random.default_rng(8)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    worst = 0
    for horizontal in (True, False):
        for n in range(1, 71):
            lines = int(rng.integers(1, 80))
            x = np.cumsum(rng.integers(-3000, 3000, (lines, n)), axis=1) // 4
            avg, res = MT._squeeze_1d(x)
            if not horizontal:
                avg, res = avg.T, res.T
            a, r = t(avg), t(res)
            got = MDEV.unsqueeze(a, r, horizontal)
            ref = MDEV.unsqueeze_plain(a, r, horizontal)
            worst = max(worst, (got.long() - ref.long()).abs().max().item())
            if not torch.equal(got, t(x if horizontal else x.T)):
                raise AssertionError(f"unsqueeze does not invert the squeeze "
                                     f"(n {n}, horizontal {horizontal})")
    note_err("unsqueeze", worst, 0, "seeded lines 1-70 steps, both axes")
    base = 1 << 29
    x = (np.where(np.arange(150) % 4 < 2, base, -base)
         + rng.integers(-1000, 1000, (37, 150)))
    avg, res = MT._squeeze_1d(x)
    for horizontal in (True, False):
        a, r = (t(avg), t(res)) if horizontal else (t(avg.T), t(res.T))
        got = MDEV.unsqueeze(a, r, horizontal)
        note_err("unsqueeze", (got.long() - MDEV.unsqueeze_plain(
            a, r, horizontal).long()).abs().max().item(), 0,
            f"values near +-2^29, horizontal {horizontal}")
        if not torch.equal(got, t(x if horizontal else x.T)):
            raise AssertionError("unsqueeze near 2^29 is not the host's")
    worst = 0
    for rct_type in range(42):
        ps = [t(rng.integers(-2**31, 2**31, (37, 53), dtype=np.int64))
              for _ in range(3)]
        worst = max(worst, (MDEV.rct_inverse(*ps, rct_type).long()
                            - MDEV.rct_inverse_plain(*ps, rct_type).long()
                            ).abs().max().item())
    note_err("rct_inverse", worst, 0, "all 42 rct_type values, int32 range")
    worst = 0
    for num_c, nb in ((1, 3), (3, 40), (4, 1), (3, 256)):
        pal = t(rng.integers(-5, 70000, (num_c, nb + 2)))
        idx = t(rng.integers(-3, nb + 9, (61, 77)))
        worst = max(worst, (MDEV.palette_inverse(pal, idx, num_c, nb).long()
                            - MDEV.palette_inverse_plain(pal, idx, num_c, nb)
                            .long()).abs().max().item())
    note_err("palette_inverse", worst, 0,
             "negative, in-range and over-range indices")


# the layers of a Modular api.decode: layer -> the functions it wraps
MODULAR_LAYERS = {
    "container/headers/TOC": ("_read_frames",),
    "global stream": ("read_global",),
    "group streams (C++)": ("read_lf_group", "read_group"),
    "h2d": ("upload",),
    "device transforms": ("undo_transforms",),
    "output": ("modular_pixels",),
    "d2h": ("d2h",),
    "rest": ("apply_orientation", "basic_info"),
}


@contextlib.contextmanager
def split_modular(log: list):
    """Wrap the functions a Modular api.decode calls so that each call
    logs its span (the device steps synchronise in their wrappers; the
    output's .cpu().numpy() logs d2h); restore them on exit."""
    saved = []

    def wrap(owner, name, wrapper):
        saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, wrapper)

    for name in ("_read_frames", "apply_orientation", "basic_info"):
        wrap(api, name, timed(getattr(api, name), name, log))
    for name in ("read_global", "read_lf_group", "read_group"):
        wrap(ModularFrameDecoder, name,
             timed(getattr(ModularFrameDecoder, name), name, log))
    for name in ("upload", "undo_transforms"):
        wrap(MDEV, name, timed(getattr(MDEV, name), name, log, sync=True))
    pixels = timed(MOUT.modular_pixels, "modular_pixels", log, sync=True)
    wrap(MOUT, "modular_pixels",
         lambda *a, **k: Pixels(pixels(*a, **k), log))
    try:
        yield
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


def modular_layers(data: bytes, mp: float, card: str, runs: int = 5) -> dict:
    """M1 for the 4K Modular decode: `runs` split api.decode calls in
    turns with as many unwrapped ones; raises if a split call's layers
    miss its own total by more than 2%.  Returns the medians (ms)."""
    med = statistics.median
    split, unsplit = [], []
    for i in range(2 * runs):
        torch.cuda.synchronize()
        if (i % 2 == 0) == (i // 2 % 2 == 0):
            log = []
            with split_modular(log), no_gc():
                t0 = time.perf_counter()
                api.decode(data, device="cuda")
                split.append(((time.perf_counter() - t0) * 1e3, log))
        else:
            with no_gc():
                t0 = time.perf_counter()
                api.decode(data, device="cuda")
                unsplit.append((time.perf_counter() - t0) * 1e3)
    per = {k: [spent(log, names) for _, log in split]
           for k, names in MODULAR_LAYERS.items()}
    sums = [sum(v[n] for v in per.values()) for n in range(len(split))]
    gaps = [abs(sums[n] - total) / total for n, (total, _) in enumerate(split)]
    for n, (total, _) in enumerate(split):
        if gaps[n] > 0.02:
            raise AssertionError(f"split Modular decode {n}: its layers sum "
                                 f"to {sums[n]:.1f} ms, the call took "
                                 f"{total:.1f} ms")
    m = {k: med(v) for k, v in per.items()}
    t_split, t_unsplit = med(t for t, _ in split), med(unsplit)
    print(f"layers 4k modular (host clock, ms, median of {runs} split "
          f"api.decode calls of the 4K RCT stream): "
          + ", ".join(f"{k} {v:.1f}" for k, v in m.items())
          + f"; sum of the medians {sum(m.values()):.1f}; each call's layers "
          f"summed, median {med(sums):.1f}, within {max(gaps):.2%} of the "
          f"call's own total; the split calls' total {t_split:.1f}; unsplit "
          f"calls {t_unsplit:.1f} (split - unsplit {t_split - t_unsplit:+.1f}"
          f" ms) [{card}]", flush=True)
    print(f"end_to_end 4k modular decode bytes->pixels (the unsplit calls): "
          f"{t_unsplit:.1f} ms = {mp / t_unsplit * 1e3:.2f} MP/s [{card}]",
          flush=True)
    return dict(m, total=t_unsplit)


def squeezed_undo(data: bytes, card: str, runs: int = 3) -> None:
    """A2 in the 1024x1024 squeezed still's whole undo_frame: its unsqueeze
    launches (one a squeeze step, over all its channels) beside the channel
    unsqueezes they carry (one launch each before the steps were batched),
    and undo_frame's host ms (synchronised), median of `runs` api.decode
    calls."""
    log, per, channels = [], [], [0]
    undo, batch = MDEV.undo_frame, MDEV.unsqueeze_batch

    def counted(pairs):
        channels[0] += len(pairs)
        return batch(pairs)

    MDEV.undo_frame = timed(undo, "undo_frame", log, sync=True)
    MDEV.unsqueeze_batch = counted
    try:
        for _ in range(runs):
            n0, c0 = MDEV.unsqueeze.launches, channels[0]
            torch.cuda.synchronize()
            api.decode(data, device="cuda")
            per.append((MDEV.unsqueeze.launches - n0, channels[0] - c0))
    finally:
        MDEV.undo_frame, MDEV.unsqueeze_batch = undo, batch
    t = statistics.median((end - start) * 1e3 for _, start, end in log)
    print(f"A2 1024x1024 squeezed undo_frame: {per[0][0]} unsqueeze launches "
          f"for {per[0][1]} channel unsqueezes (one launch each before "
          f"batching); undo_frame {t:.3f} host ms (synchronised, median of "
          f"{runs} api.decode calls) [{card}]", flush=True)


def once_ms(fn) -> float:
    """Milliseconds of one warm call of fn, CUDA events (for a twin whose
    call takes seconds)."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


def unsqueeze_bound(lines: int, steps: int, clock_mhz: float,
                    name: str = "unsqueeze") -> None:
    """max(the chain: steps x UNSQUEEZE_STEP_CYCLES at the SM clock, the
    bytes: averages, residuals and outputs once)."""
    chain_ms = steps * UNSQUEEZE_STEP_CYCLES / (clock_mhz * 1e3)
    bytes_ms = lines * (2 * steps + 2 * steps) * 4 / HBM_BYTES_PER_S * 1e3
    BOUND[name] = ((chain_ms, "operations") if chain_ms >= bytes_ms
                   else (bytes_ms, "bytes"))
    print(f"bound {name}: {steps} steps x {UNSQUEEZE_STEP_CYCLES} cycles at "
          f"{clock_mhz:.0f} MHz = {chain_ms:.4f} ms; {lines} lines' bytes "
          f"{bytes_ms:.4f} ms", flush=True)


def modular_timings(inputs: dict, dev, card: str, ms: dict) -> None:
    """Each Modular kernel at 4K by CUDA graph against its plain twin and
    its bound: the unsqueeze on the first horizontal and vertical squeeze
    of a 4K plane (the twin's Python loop over the steps is host-bound: one
    call by CUDA events), the inverse RCT and the palette gather on the
    inputs the 4K streams gave them."""
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    plane = bench_frame(2160, 3840)[..., 1].astype(np.int64) * 37 - 4000
    for horizontal in (True, False):
        x = plane if horizontal else plane.T
        avg, res = MT._squeeze_1d(x)
        if not horizontal:
            avg, res = avg.T, res.T
        a, r = (torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)
                for v in (avg, res))
        got = MDEV.unsqueeze(a, r, horizontal)
        note_err("unsqueeze", (got.long() - MDEV.unsqueeze_plain(
            a, r, horizontal).long()).abs().max().item(), 0,
            f"4k plane, horizontal {horizontal}")
        name = "unsqueeze" if horizontal else "unsqueeze vertical"
        lines, steps = (a.shape[0], a.shape[1]) if horizontal else \
            (a.shape[1], a.shape[0])
        unsqueeze_bound(lines, steps, clock, name)
        t = (graph_ms(lambda: MDEV.unsqueeze(a, r, horizontal)),
             once_ms(lambda: MDEV.unsqueeze_plain(a, r, horizontal)))
        if horizontal:
            ms["unsqueeze"] = t
        print(f"kernel unsqueeze at 4k {'horizontal' if horizontal else 'vertical'}"
              f" ({lines} lines of {steps} steps): device {t[0]:.4f} ms (CUDA "
              f"graph), plain twin {t[1]:.1f} ms (host-bound Python loop, CUDA "
              f"events), bound {BOUND[name][0]:.4f} ms [{card}]", flush=True)
    c0, c1, c2, rct_type = inputs["rct_inverse"]
    px = c0.numel()
    note_bound("rct_inverse", 6 * 4 * px, 0)
    ms["rct_inverse"] = (graph_ms(lambda: MDEV.rct_inverse(c0, c1, c2, rct_type)),
                         device_ms(lambda: MDEV.rct_inverse_plain(c0, c1, c2,
                                                                  rct_type)))
    pal, idx, num_c, nb = inputs["palette_inverse"]
    note_bound("palette_inverse", nbytes(pal, idx) + num_c * 4 * idx.numel(), 0)
    ms["palette_inverse"] = (
        graph_ms(lambda: MDEV.palette_inverse(pal, idx, num_c, nb)),
        device_ms(lambda: MDEV.palette_inverse_plain(pal, idx, num_c, nb)))
    flat = idx.reshape(-1)
    if int(idx.min()) >= 0 and int(idx.max()) < nb:
        # every index in range: one index_select is the same function
        LIBRARY_MS["palette_inverse"] = graph_ms(
            lambda: torch.index_select(pal[:, :nb], 1, flat))
    for k in ("rct_inverse", "palette_inverse"):
        print(f"kernel {k} at 4k: device {ms[k][0]:.4f} ms (CUDA graph), plain "
              f"twin {ms[k][1]:.4f} ms, bound {BOUND[k][0]:.4f} ms"
              + (f", index_select {LIBRARY_MS[k]:.4f} ms"
                 if LIBRARY_MS[k] is not None else "") + f" [{card}]",
              flush=True)


def modular_phase(jobs: dict, dev, card: str, ms: dict) -> dict:
    """Phase 11: the Modular decode.  The kernels against their twins on
    seeded inputs; the main path through api.decode(data, "cuda") on every
    stream, counted, each transform in a stream's headers launching its
    kernel; the pixels against the source and the CPU route; every kernel
    call of the main path against its twin; M1 at 4K; timings."""
    check_modular_seeded(dev)
    streams = {}
    for label, job in jobs.items():
        data, cpu, seconds = job.get()
        streams[label] = (data, cpu)
        print(f"modular stream {label}: {len(data)} bytes; the CPU route's "
              f"decode {seconds:.1f} s (a worker process)", flush=True)
    seen, current = {}, [None]
    # the transforms' kernels, and kernel 2 for the XYB output
    path_kernels = MODULAR_KERNELS + ("restore_and_output",)

    def main_path():
        outs, per_stream = {}, {}
        for label, (data, _cpu) in streams.items():
            current[0] = label
            before = {k: KERNELS[k]["fn"].launches for k in path_kernels}
            outs[label] = api.decode(data, device="cuda")[0]
            per_stream[label] = {k: KERNELS[k]["fn"].launches - before[k]
                                 for k in path_kernels}
        return outs, per_stream

    with contextlib.ExitStack() as stack:
        stack.enter_context(modular_transforms_seen(seen, current))
        for module, names in MODULAR_TWINS:
            stack.enter_context(forbidden(module, names))
        (outs, per_stream), counts = drive(
            "main path (Modular api.decode)", main_path, path_kernels)
    for label, launches in per_stream.items():
        ids = sorted({t.id for _, header in seen.get(label, [])
                      for t in header.transforms})
        print(f"modular {label}: transforms {ids} (0 RCT, 1 palette, 2 "
              f"squeeze), launches {launches}", flush=True)
        for i in ids:
            if launches[TRANSFORM_KERNEL[i]] <= 0:
                raise AssertionError(f"modular {label}: transform {i} in its "
                                     f"headers, {TRANSFORM_KERNEL[i]} launched "
                                     f"0 times")
        want = int(label == "xyb")
        if launches["restore_and_output"] != want:
            raise AssertionError(f"modular {label}: restore_and_output "
                                 f"launched {launches['restore_and_output']} "
                                 f"times, expected {want}")
    for label, (data, cpu) in streams.items():
        got = outs[label]
        if label == "xyb":
            within_one_code(got, cpu, f"modular {label} vs the CPU route")
            continue
        src = MODULAR_STREAMS[label][0]()
        same_cpu = got.shape == cpu.shape and got.dtype == cpu.dtype and \
            np.array_equal(got, cpu)
        same_src = got.shape == src.shape and got.dtype == src.dtype and \
            np.array_equal(got, src)
        print(f"modular {label}: {got.shape} {got.dtype}, equal to the CPU "
              f"route {same_cpu}, to the source {same_src}", flush=True)
        if not (same_cpu and same_src):
            raise AssertionError(f"modular {label}: lossless decode differs")
    # every kernel call of the main path against its twin, exactly
    calls = {}
    with twin_checked(calls):
        for label, (data, _cpu) in streams.items():
            api.decode(data, device="cuda")
    for k in MODULAR_KERNELS:
        n, worst = calls.get(k, (0, 0))
        note_err(k, worst, 0, f"every call of the main path's six streams "
                              f"({n} calls)")
    # the 4K inputs of the RCT and the palette gather, as the main path gave
    # them (the undo's channel tensors at entry; the kernels make new ones)
    chans, header = seen["4k_rct"][0]
    t = header.transforms[0]
    inputs = {"rct_inverse": (*chans[t.begin_c:t.begin_c + 3], t.rct_type)}
    chans, header = seen["4k_palette"][0]
    t = header.transforms[0]
    inputs["palette_inverse"] = (chans[0], chans[t.begin_c + 1], t.num_c,
                                 t.nb_colours)
    layers = modular_layers(streams["4k_rct"][0], 3840 * 2160 / 1e6, card)
    squeezed_undo(streams["1024_squeezed"][0], card)
    modular_timings(inputs, dev, card, ms)
    return dict(counts, layers=layers,
                streams={label: data for label, (data, _) in streams.items()})


# ---- the VarDCT post stages (phase 12) ----

POST_KERNELS = ("add_noise", "upsample", "encode_output")
# what a post-stage decode on the card must not run: the kernels' plain
# twins and the plain output functions
POST_TWINS = ((post, ("add_noise_plain", "upsample_plain",
                      "encode_output_plain")),
              (filters, ("restore_and_output_plain",)),
              (color, ("xyb_to_srgb_plain",)),
              (MDEV, ("unsqueeze_plain", "rct_inverse_plain",
                      "palette_inverse_plain")))
# the host encoder's sources: a change to any of them re-encodes
POST_WRITER = [sys.modules[m].__file__ for m in (
    "port_fixtures", "jxl_coder_tpu_torch.host.vardct.enc_real",
    "jxl_coder_tpu_torch.host.ops.color", "jxl_coder_tpu_torch.host.codec",
    "jxl_coder_tpu_torch.host.modular.stream")]
# least f32 operations per pixel (an FMA counts 2):
#   noise: the three 5x5 box sums as running sums (4 a plane), centre
#     minus the sum / 25 (2 a plane), the two strengths' index, fraction
#     and interpolation (6 each), red and green (3 each), X / Y / B (2 each;
#     the sum red + green shared, 1): 12 + 6 + 12 + 6 + 7 = 43;
#   upsampling, per output sample: 25 FMAs (50) and the clamp (2), the
#     window's min and max (48 a source sample) shared by n^2 outputs
POST_OPS = {"add_noise": 43, "upsample": 52}
# A7 counted in SASS instructions (the instruction slots a lane spends;
# the card runs 132 SMs x 128 lanes of them a cycle at its highest SM clock,
# 1,980 MHz), each powf, logf, sqrtf and IEEE division at the instructions
# read off cuobjdump -sass of post.cu's encode_output_kernel<4, uint16_t,
# K_ENC, T_PQ, true> (powf, division) and <4, uint16_t, K_ENC, T_HLG, true>
# (logf, sqrtf) on sm_90a, nvcc -fmad=false (modular_vs_other.py
# --only=a7 --sass=DIR writes it).  SASS_NEEDED, which sets the bound, is
# the work each call needs for a finite positive argument and a normal
# result: powf's reduction, logarithm, exponential and scaling (56), the
# division's reciprocal and its five-step refinement (6), sqrtf's
# reciprocal square root and its refinement (5), logf's reduction and
# polynomial (21).  SASS_COMMON is what the kernel issues on that path, an
# issue-rate figure printed beside the bound: it adds the convergence
# barriers and the tests, selects and branches over special cases (a base
# of 1, an exponent of 0, overflow, NaN, infinities, a negative base or an
# integer exponent: powf 86), the division's FCHK and the branch past its
# slow path (10), sqrtf's range test (10) and logf's zero and infinity
# selects (26).  The other operations count one instruction each: the
# linear values (the cubes and biases 14, the opsin mix 15), the gamut
# mix (15), and per channel the transfer function's own operations, the
# sign (3) and the code (5)
SASS_NEEDED = {"powf": 56, "logf": 21, "sqrtf": 5, "div": 6}
SASS_COMMON = {"powf": 86, "logf": 26, "sqrtf": 10, "div": 10}
SASS_PER_S = 132 * 128 * 1.98e9


def a7_instructions(spec: tuple, k: dict = SASS_NEEDED) -> int:
    """A7's SASS instructions a pixel for an output spec, with each call
    counted at k (SASS_NEEDED: the bound's; SASS_COMMON: what the kernel
    issues): the arithmetic above; HLG's values at or below 1/12 take the
    square root, the others the logarithm, so a pixel counts the cheaper
    branch."""
    if spec[0] == "srgb":
        return OPS_PX["srgb"]
    if spec[0] == "ycbcr":
        return 9 + 3 * 5
    base = 14 + 15
    if spec[0] == "gamma":
        return base + 3 * (1 + k["powf"] + 5)
    trc, gm = spec[1], spec[2] is not None
    per = {8: 1, 1: 4 + k["powf"], 17: k["powf"],
           16: 1 + 4 + 2 * k["powf"] + k["div"],
           18: 3 + min(1 + k["sqrtf"], 5 + k["logf"])}.get(
               trc, 4 + k["powf"])
    # HLG's display values (3), their luma (5) and its power (3 + powf)
    extra = 3 + 5 + 3 + k["powf"] if trc == 18 else 0
    return base + 15 * gm + extra + 3 * (per + 3 + 5)


# PQ codes: mean, 99.9th percentile, and the share of values beyond 64
# codes.  Near black PQ is steep enough that a float32 difference of ~1e-5
# in an XYB value moves a 16-bit code by a hundred or more, and no float32
# decode keeps a max of 64 codes there against the float64 one: the JAX
# package's own device route differs from its host decode by up to 1,153
# codes on a 960x540 cut of the 4K post stream (6 values of 1.5 million
# beyond 64).  The max is printed; the share beyond 64 codes is bounded.
PQ_LIMITS = (0.5, 8, 64)
PQ_OVER_SHARE = 1e-5


def _colour(trc: int = 13, prim: int = 1, gamma: float = None):
    from jxl_coder_tpu_torch.host.bitstream.headers import ColourEncoding
    ce = ColourEncoding()
    ce.transfer_function, ce.primaries = trc, prim
    if gamma is not None:
        ce.have_gamma, ce.gamma = True, int(round(gamma * 1e7))
    return ce


def rgba8_frame(h: int, w: int) -> np.ndarray:
    alpha = (np.mgrid[0:h, 0:w][0] * 255 // max(h - 1, 1)).astype(np.uint8)
    return np.concatenate([bench_frame(h, w), alpha[..., None]], -1)


# label: (the source image at its full size, the stream's options)
POST_STREAMS = {
    # the slice's full-size stream: lossy alpha, photon noise (ISO 3200)
    # and 16-bit PQ with BT.2100 primaries
    "4k_rgba16_noise_pq": (lambda: rgba16_frame(2160, 3840),
                           dict(noise=3200, colour=(16, 9), it=4000.0)),
    # coded at 1920x1080, decoded at 3840x2160
    "4k_from_fhd_up2": (lambda: bench_frame(2160, 3840), dict(up=2)),
    "hlg_2100": (lambda: bench_frame(480, 720), dict(colour=(18, 9),
                                                     it=1000.0)),
    "gamma_2.2": (lambda: bench_frame(480, 720), dict(gamma=1 / 2.2)),
    "bt709": (lambda: bench_frame(480, 720), dict(colour=(1, 1), it=255.0)),
    "up4": (lambda: bench_frame(964, 1284), dict(up=4)),
    "up8": (lambda: bench_frame(964, 1284), dict(up=8)),
    "modular_rgba_up2": (lambda: rgba8_frame(1024, 1024), dict(modular=2)),
}


def write_post(img: np.ndarray, opts: dict) -> bytes:
    """The stream of one POST_STREAMS entry, by the port's host encoder
    (VarDCT, effort 7, distance 1) or its Modular fixture writer."""
    from jxl_coder_tpu_torch.host.bitstream.frame_header import FrameHeader
    from jxl_coder_tpu_torch.host.bitstream.headers import (
        BitDepth, ImageHeader, ImageMetadata, SizeHeader)
    if "modular" in opts:
        return upsampled_modular_still(img, opts["modular"])
    kw = dict(distance=1.0, effort=7)
    if img.shape[2] == 4:
        img, kw["alpha"] = img[..., :3], img[..., 3]
    if "noise" in opts:
        kw["noise_lut"] = reference.photon_noise_lut(opts["noise"])
    if "colour" in opts:
        kw["colour"] = _colour(*opts["colour"])
        kw["intensity_target"] = opts["it"]
    if "gamma" in opts:
        kw["colour"] = _colour(gamma=opts["gamma"])
    if "up" in opts:
        n = opts["up"]
        m = ImageMetadata()
        m.bit_depth = BitDepth(False, 8, 0)
        kw["hdr"] = ImageHeader(size=SizeHeader(xsize=img.shape[1],
                                                ysize=img.shape[0]),
                                metadata=m)
        kw["fh"] = FrameHeader(upsampling=n)
        img = np.ascontiguousarray(img[::n, ::n])
    return reference.encode_vardct(img, **kw)


def post_job(label: str):
    """In a worker process: the stream (encoded once per machine, cached)
    and its reference: the float64 host decoder, or for the Modular
    stream the CPU route -> (bytes, pixels, seconds)."""
    torch.set_num_threads(1)
    make, opts = POST_STREAMS[label]
    img = make()
    data = cached(img, f"post {label} {sorted(opts.items())}", POST_WRITER,
                  lambda: write_post(img, opts))
    t0 = time.perf_counter()
    ref = (api.decode(data, device="cpu")[0] if "modular" in opts
           else reference.decode_float64(data))
    return data, ref, time.perf_counter() - t0


def expected_launches(opts: dict) -> dict:
    if "modular" in opts:     # colour and alpha, each upsampled
        return dict(add_noise=0, upsample=2, encode_output=0,
                    restore_and_output=0)
    return dict(add_noise=int("noise" in opts), upsample=int("up" in opts),
                encode_output=1, restore_and_output=1)


def pq_codes(got: np.ndarray, ref: np.ndarray) -> tuple:
    """(mean, 99.9th percentile, max, share of values beyond PQ_LIMITS'
    64 codes) of the code differences."""
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    return (float(d.mean()), float(np.percentile(d, 99.9)), int(d.max()),
            float((d > PQ_LIMITS[2]).mean()))


def pq_within(codes: tuple) -> bool:
    mean, p999, _mx, over = codes
    return (mean < PQ_LIMITS[0] and p999 <= PQ_LIMITS[1]
            and over <= PQ_OVER_SHARE)


def pq_what(codes: tuple) -> str:
    mean, p999, mx, over = codes
    return (f"mean {mean:.4g}, 99.9th percentile {p999:g}, max {mx}, share "
            f"beyond {PQ_LIMITS[2]} codes {over:.3g}")


def check_post_decode(label: str, got: np.ndarray, ref: np.ndarray,
                      opts: dict) -> None:
    """The colour within 2 codes of the reference (PQ: pq_within), extra
    channels equal."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"post {label}: {got.shape} {got.dtype} vs "
                             f"{ref.shape} {ref.dtype}")
    ec_equal = np.array_equal(got[..., 3:], ref[..., 3:])
    if "modular" in opts:
        same = np.array_equal(got, ref)
        print(f"decode post {label}: {got.shape} {got.dtype}, equal to the "
              f"CPU route {same}", flush=True)
        if not same:
            raise AssertionError(f"post {label}: differs from the CPU route")
        return
    col = (got[..., :3], ref[..., :3])
    if opts.get("colour", (0,))[0] == 16:
        codes = pq_codes(*col)
        ok, what = pq_within(codes), pq_what(codes)
        d = np.abs(col[0].astype(np.int64) - col[1].astype(np.int64))
        worst = np.argsort(d, axis=None)[-5:][::-1]
        what += "; the largest at (code, reference code) " + ", ".join(
            f"({col[0].flat[i]}, {col[1].flat[i]})" for i in worst)
    else:
        d = np.abs(col[0].astype(np.int64) - col[1].astype(np.int64))
        ok = d.max() <= 2
        what = f"max {d.max()}, differing share {float((d > 0).mean()):.3g}"
    print(f"decode post {label}: {got.shape} {got.dtype} vs the float64 host "
          f"decoder: {what}; extra channels equal {ec_equal}", flush=True)
    if not (ok and ec_equal):
        raise AssertionError(f"post {label}: outside its limits ({what}, "
                             f"extra channels equal {ec_equal})")


@contextlib.contextmanager
def kernel2_outs(outs: list):
    """Record the `out` of each restore_and_output call VarDCTFrame
    makes."""
    from jxl_coder_tpu_torch.vardct import frame as FRAME
    orig = FRAME.restore_and_output

    def recorded(*args, **kwargs):
        outs.append(args[7] if len(args) > 7 else kwargs.get("out", "u8"))
        return orig(*args, **kwargs)

    FRAME.restore_and_output = recorded
    try:
        yield
    finally:
        FRAME.restore_and_output = orig


def note_post(name: str, got: torch.Tensor, ref: torch.Tensor,
              what: str, pq: bool = False, spec_key: str = None) -> None:
    """f32 planes within 1e-6; codes equal, or within PQ's limits; spec_key:
    A7's largest difference kept by output spec (A7_MAX).  The codes'
    rule is 0 for every spec but PQ: the kernel this one replaced gave 0
    on every check of phase 12 and on the 4K planes of
    modular_vs_other.py --only=a7 at 8 and 16 bits (NVIDIA H100 80GB
    HBM3)."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name} {what}: {tuple(got.shape)} "
                             f"{got.dtype} vs {tuple(ref.shape)} {ref.dtype}")
    if got.dtype == torch.float32:
        note_err(name, (got - ref).abs().max().item(), 1e-6, what)
        return
    d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
    if spec_key is not None:
        A7_MAX[spec_key] = max(A7_MAX.get(spec_key, 0), int(d.max()))
    if pq:
        codes = pq_codes(got.cpu().numpy(), ref.cpu().numpy())
        ERR[name] = max(ERR[name], float(codes[2]))
        print(f"parity {name:12s} {what}: {pq_what(codes)}", flush=True)
        if not pq_within(codes):
            raise AssertionError(f"{name} {what}: PQ codes outside limits")
    else:
        note_err(name, d.max().item(), 0, what)


POST_SPECS = {"srgb": ("srgb",), "gamma": ("gamma", 1 / 2.2),
              "pq_2100": ("enc", 16, "2020", 4000.0),
              "hlg_2100": ("enc", 18, "2020", 1000.0),
              "srgb_2020": ("enc", 13, "2020", 255.0),
              "bt709": ("enc", 1, None, 255.0),
              "linear": ("enc", 8, None, 255.0),
              "dci": ("enc", 17, None, 255.0)}


# A7's largest code difference from its twin seen by output spec
# (printed in phase 12)
A7_MAX = {}


def note_a7(got: torch.Tensor, ref: torch.Tensor, key: str,
            what: str) -> None:
    """A7's codes against the twin's (note_post's rule)."""
    note_post("encode_output", got, ref, f"{what} {key}",
              pq=key.startswith("pq"), spec_key=key)


def post_spec(key: str) -> tuple:
    """A POST_SPECS entry in encode_output's form (the gamut matrix and
    luma weights from the port's host colour copy)."""
    from jxl_coder_tpu_torch.host.ops import color as HC
    spec = POST_SPECS[key]
    if spec[0] != "enc":
        return spec
    prim = HC.PRIMARIES["bt2020" if spec[2] else "srgb"]
    gm = None
    if spec[2]:
        gm = tuple((HC.gamut_xyz_to_rgb(prim, HC.ILLUMINANT_D65)
                    @ HC.gamut_rgb_to_xyz(HC.PRIMARIES["srgb"],
                                          HC.ILLUMINANT_D65))
                   .astype(np.float32).reshape(-1).tolist())
    luma = tuple(HC.gamut_rgb_to_xyz(prim, HC.ILLUMINANT_D65)[1]
                 .astype(np.float32).tolist())
    return ("enc", spec[1], gm, spec[3], luma)


def seeded_xyb(h: int, w: int, rng, bright: float = 0.85) -> torch.Tensor:
    y = rng.uniform(0.0, bright, (h, w))
    return torch.from_numpy(np.stack([rng.normal(0.0, 0.012, (h, w)), y,
                                      y + rng.normal(0.0, 0.04, (h, w))])
                            .astype(np.float32))


def check_post_seeded(dev) -> None:
    """Each post kernel against its twin on seeded planes from 1x1 up
    (planes smaller than the 2-pixel mirrored halo included): noise and
    upsampling (n 2, 4, 8) f32 within 1e-6, the output encoding's codes
    for every spec at 8 and 16 bits."""
    rng = np.random.default_rng(12)
    for h, w in ((1, 1), (1, 5), (2, 3), (4, 4), (5, 2), (3, 7), (17, 33),
                 (70, 131)):
        x = seeded_xyb(h, w, rng).to(dev)
        rnd = torch.from_numpy(rng.random((3, h, w)).astype(np.float32)
                               - 0.5).to(dev)
        lut = torch.tensor(reference.photon_noise_lut(3200),
                           dtype=torch.float32, device=dev)
        note_post("add_noise", post.add_noise(x.clone(), rnd, lut),
                  post.add_noise_plain(x.clone(), rnd, lut), f"seeded {h}x{w}")
        for n in (2, 4, 8):
            ker = post.kernels_for(n, device=dev)
            note_post("upsample", post.upsample(x, ker),
                      post.upsample_plain(x, ker), f"seeded {h}x{w} n {n}")
        hx = seeded_xyb(h, w, rng, 1.6).to(dev)
        for key in POST_SPECS:
            spec = post_spec(key)
            for bits in (8, 16):
                src = hx if spec[0] == "enc" else x
                note_a7(post.encode_output(src, spec, bits),
                        post.encode_output_plain(src, spec, bits), key,
                        f"seeded {h}x{w} {bits}-bit")


# the layers of a post-stage api.decode: layer -> the functions it wraps;
# each layer's time is its spans on the main thread less the spans nested
# in them (the EC group streams of a frame of several groups run inside
# the pass groups' threads, within the parse: summed apart)
POST_LAYERS = {
    "parse": ("_read_frames", "parse_frame"),
    "EC channel decode": ("read_global", "read_group"),
    "pack": ("pack",),
    "EC h2d + transforms": ("undo_frame",),
    "h2d": ("from_prepared",),
    "synthesis + kernel 2": ("reconstruct",),
    "noise-plane build": ("noise_random",),
    "A5 noise": ("add_noise",),
    "A6 upsampling": ("upsample",),
    "A7 output": ("encode_output",),
    "EC output": ("extra_channels",),
    "frame rest (launch work, EC stack)": ("frame",),
    "d2h": ("d2h",),
    "rest": ("apply_orientation", "basic_info", "PostConfig.of"),
}


def exclusive_ms(log: list) -> tuple:
    """(name -> ms of the main thread's spans less their nested spans,
    name -> ms summed over the spans of other threads)."""
    main = threading.get_ident()
    own, other = {}, {}
    spans = sorted((t0, -t1, n) for n, t0, t1, tid in log if tid == main)
    stack = []
    for t0, neg_t1, n in spans:
        t1 = -neg_t1
        while stack and stack[-1][1] <= t0:
            stack.pop()
        if stack:
            own[stack[-1][0]] = own.get(stack[-1][0], 0.0) - (t1 - t0)
        own[n] = own.get(n, 0.0) + (t1 - t0)
        stack.append((n, t1))
    for n, t0, t1, tid in log:
        if tid != main:
            other[n] = other.get(n, 0.0) + (t1 - t0)
    return ({k: v * 1e3 for k, v in own.items()},
            {k: v * 1e3 for k, v in other.items()})


def tspan(fn, name: str, log: list, sync: bool = False):
    """fn, logging (name, start, end, thread) per call; with sync, the call
    ends with torch.cuda.synchronize()."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            return out
        finally:
            log.append((name, t0, time.perf_counter(),
                        threading.get_ident()))
    return call


@contextlib.contextmanager
def split_post(log: list):
    """Wrap the functions a post-stage api.decode calls (the device steps
    synchronise in their wrappers); restore them on exit."""
    from jxl_coder_tpu_torch.host.modular.frame import ModularFrameDecoder
    from jxl_coder_tpu_torch.vardct import frame as FRAME
    saved = []

    def wrap(owner, name, wrapper):
        saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, wrapper)

    for name in ("_read_frames", "parse_frame", "pack", "from_prepared",
                 "apply_orientation", "basic_info"):
        wrap(api, name, tspan(getattr(api, name), name, log))
    wrap(api, "PostConfig", type("PostConfig", (), {"of": staticmethod(
        tspan(api.PostConfig.of, "PostConfig.of", log))}))
    for name in ("read_global", "read_group"):
        wrap(ModularFrameDecoder, name,
             tspan(getattr(ModularFrameDecoder, name), name, log))
    wrap(MDEV, "undo_frame", tspan(MDEV.undo_frame, "undo_frame", log,
                                   sync=True))
    wrap(post, "noise_random", tspan(post.noise_random, "noise_random", log,
                                     sync=True))
    for name in POST_KERNELS + ("extra_channels",):
        wrap(post, name, tspan(getattr(post, name), name, log, sync=True))
    wrap(FRAME, "extra_channels", post.extra_channels)
    wrap(FRAME.VarDCTFrame, "reconstruct",
         tspan(FRAME.VarDCTFrame.reconstruct, "reconstruct", log, sync=True))
    real = FRAME.VarDCTFrame

    class Frame:
        def __init__(self, cfg):
            self.frame = real(cfg)

        def __call__(self, frame_inputs):
            px = tspan(self.frame, "frame", log, sync=True)(frame_inputs)
            return PixelsT(px, log)

    wrap(api, "VarDCTFrame", Frame)
    try:
        yield
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


class PixelsT(Pixels):
    def cpu(self):
        t0 = time.perf_counter()
        host = self.px.cpu()
        log = self.log

        class Host:
            def numpy(self):
                out = host.numpy()
                log.append(("d2h", t0, time.perf_counter(),
                            threading.get_ident()))
                return out
        return Host()


def post_layers(label: str, data: bytes, mp: float, card: str,
                runs: int = 5) -> dict:
    """M1 for a post-stage decode: `runs` split api.decode calls in turns
    with as many unwrapped ones; the noise planes' cache emptied before the
    first split call, so that it times their first build; raises if a
    split call's layers miss its own total by more than 2%."""
    med = statistics.median
    split, unsplit = [], []
    post._NOISE_RND.clear()
    for i in range(2 * runs):
        torch.cuda.synchronize()
        if (i % 2 == 0) == (i // 2 % 2 == 0):
            log = []
            with split_post(log), no_gc():
                t0 = time.perf_counter()
                api.decode(data, device="cuda")
                split.append(((time.perf_counter() - t0) * 1e3, log))
        else:
            with no_gc():
                t0 = time.perf_counter()
                api.decode(data, device="cuda")
                unsplit.append((time.perf_counter() - t0) * 1e3)
    per, threads = {k: [] for k in POST_LAYERS}, []
    for total, log in split:
        own, other = exclusive_ms(log)
        for k, names in POST_LAYERS.items():
            per[k].append(sum(own.get(n, 0.0) for n in names))
        threads.append(other.get("read_group", 0.0))
    sums = [sum(v[n] for v in per.values()) for n in range(len(split))]
    gaps = [abs(sums[n] - total) / total for n, (total, _) in enumerate(split)]
    for n, (total, _) in enumerate(split):
        if gaps[n] > 0.02:
            raise AssertionError(f"split post decode {label} {n}: its layers "
                                 f"sum to {sums[n]:.1f} ms, the call took "
                                 f"{total:.1f} ms")
    m = {k: med(v) for k, v in per.items()}
    first_build = per["noise-plane build"][0]
    t_split, t_unsplit = med(t for t, _ in split), med(unsplit)
    print(f"layers post {label} (host clock, ms, median of {runs} split "
          f"api.decode calls): " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in m.items())
          + f"; the noise planes' first build {first_build:.1f}; the EC group"
          f" streams inside the pass groups' threads {med(threads):.1f} "
          f"summed over threads; each call's layers summed, median "
          f"{med(sums):.1f}, within {max(gaps):.2%} of the call's own total; "
          f"the split calls' total {t_split:.1f}; unsplit calls "
          f"{t_unsplit:.1f} [{card}]", flush=True)
    print(f"end_to_end post {label} decode bytes->pixels (the unsplit calls):"
          f" {t_unsplit:.1f} ms = {mp / t_unsplit * 1e3:.2f} MP/s [{card}]",
          flush=True)
    return dict(m, total=t_unsplit, first_build=first_build)


@contextlib.contextmanager
def a7_recorded(calls: list, current: list):
    """Record each encode_output call: (the stream's label current[0], the
    planes, spec, bits).  The planes are kept, not copied: nothing writes
    them after the call."""
    orig = post.encode_output

    @functools.wraps(orig)
    def call(xyb, spec, bits):
        before = call.launches
        out = orig(xyb, spec, bits)
        # orig counts through its module's name, now this wrapper's
        orig.launches += call.launches - before
        calls.append((current[0], xyb, spec, bits))
        return out

    post.encode_output = call
    try:
        yield
    finally:
        post.encode_output = orig


def a7_bound(px: int, out_bytes: int, spec: tuple) -> tuple:
    """(bound ms, "bytes" | "operations", the byte term, the instruction
    term, the issue figure): 12 B of planes read a pixel and the codes
    written, against a7_instructions at SASS_PER_S (SASS_NEEDED; the issue
    figure SASS_COMMON's)."""
    b = (12 * px + out_bytes) / HBM_BYTES_PER_S * 1e3
    o = px * a7_instructions(spec) / SASS_PER_S * 1e3
    i = px * a7_instructions(spec, SASS_COMMON) / SASS_PER_S * 1e3
    return (max(b, o), "bytes" if b >= o else "operations", b, o, i)


def a7_launch_timings(calls: list, launches: int, card: str) -> None:
    """Each A7 launch of the counted main path at its own size and spec, by
    CUDA graph, beside its bound (bytes, and the SASS instructions it
    needs) and the instructions it issues."""
    if len(calls) != launches:
        raise AssertionError(f"encode_output: {len(calls)} calls recorded, "
                             f"{launches} launches counted")
    for k, (label, xyb, spec, bits) in enumerate(calls):
        out = post.encode_output(xyb, spec, bits)
        t = graph_ms(lambda: post.encode_output(xyb, spec, bits))
        bound, by, b, o, i = a7_bound(xyb[0].numel(), nbytes(out), spec)
        print(f"kernel encode_output launch {k + 1}/{len(calls)} ({label}): "
              f"{tuple(xyb.shape)} -> {tuple(out.shape)} {spec[:2]} "
              f"{bits}-bit: {t:.4f} ms (CUDA graph), bound {bound:.4f} ms "
              f"({by}; bytes {b:.4f}, {a7_instructions(spec)} SASS "
              f"instructions a pixel needed {o:.4f}); issued "
              f"{a7_instructions(spec, SASS_COMMON)} a pixel {i:.4f} "
              f"[{card}]", flush=True)


def post_timings(inputs: dict, card: str, ms: dict) -> None:
    """Each post kernel at 4K by CUDA graph against its twin (CUDA events)
    and its bound, on the inputs the main path gave it."""
    xyb, rnd, lut = inputs["add_noise"]
    px = xyb[0].numel()
    note_bound("add_noise", 2 * nbytes(xyb) + nbytes(rnd),
               px * POST_OPS["add_noise"])
    ms["add_noise"] = (graph_ms(lambda: post.add_noise(xyb, rnd, lut)),
                       device_ms(lambda: post.add_noise_plain(xyb.clone(), rnd,
                                                             lut)))
    planes, ker = inputs["upsample"]
    n = ker.shape[0]
    out_px = planes.numel() * n * n
    note_bound("upsample", nbytes(planes) + 4 * out_px,
               out_px * POST_OPS["upsample"])
    ms["upsample"] = (graph_ms(lambda: post.upsample(planes, ker)),
                      device_ms(lambda: post.upsample_plain(planes, ker)))
    src, spec, bits = inputs["encode_output"]
    px = src[0].numel()
    note_bound("encode_output", 12 * px + 3 * px * (2 if bits > 8 else 1),
               px * a7_instructions(spec), SASS_PER_S, "SASS instruction")
    issued = a7_instructions(spec, SASS_COMMON)
    print(f"issue encode_output: {issued} SASS instructions a pixel issued "
          f"(powf's and the division's tests and branches included), "
          f"{px * issued / SASS_PER_S * 1e3:.4f} ms at {SASS_PER_S:.4g} a "
          f"second", flush=True)
    ms["encode_output"] = (
        graph_ms(lambda: post.encode_output(src, spec, bits)),
        device_ms(lambda: post.encode_output_plain(src, spec, bits)))
    shapes = {"add_noise": tuple(xyb.shape), "upsample":
              f"{tuple(planes.shape)} x{n}", "encode_output":
              f"{tuple(src.shape)} {spec[:2]} {bits}-bit"}
    for k in POST_KERNELS:
        print(f"kernel {k} at 4k {shapes[k]}: device {ms[k][0]:.4f} ms (CUDA "
              f"graph), plain twin {ms[k][1]:.4f} ms, bound "
              f"{BOUND[k][0]:.4f} ms ({BOUND[k][1]}), no PyTorch call computes"
              f" it [{card}]", flush=True)


def post_phase(jobs: dict, dev, card: str, ms: dict) -> dict:
    """Phase 12: the VarDCT post stages.  The kernels against their twins on
    seeded planes; the main path through api.decode(data, "cuda") on every
    stream, counted, the twins made to raise; each decode against its
    reference; the kernels against their twins on the main path's 4K
    inputs; M1 for the 4K post stream and the 2x-upsampled 4K stream;
    timings."""
    t_phase = time.perf_counter()
    check_post_seeded(dev)
    streams = {}
    for label, job in jobs.items():
        data, ref, seconds = job.get()
        streams[label] = (data, ref)
        print(f"post stream {label}: {len(data)} bytes; its reference decode "
              f"{seconds:.1f} s (a worker process)", flush=True)
    path_kernels = POST_KERNELS + ("restore_and_output",)
    outs2 = []
    a7_calls, current = [], [None]

    def main_path():
        got, per_stream = {}, {}
        del a7_calls[:]
        for label, (data, _ref) in streams.items():
            before = {k: KERNELS[k]["fn"].launches for k in path_kernels}
            del outs2[:]
            current[0] = label
            got[label] = api.decode(data, device="cuda")[0]
            per_stream[label] = ({k: KERNELS[k]["fn"].launches - before[k]
                                  for k in path_kernels}, list(outs2))
        return got, per_stream

    with contextlib.ExitStack() as stack:
        stack.enter_context(kernel2_outs(outs2))
        stack.enter_context(a7_recorded(a7_calls, current))
        for module, names in POST_TWINS:
            stack.enter_context(forbidden(module, names))
        (got, per_stream), counts = drive(
            "main path (post-stage api.decode)", main_path, POST_KERNELS)
    for label, (launches, k2_outs) in per_stream.items():
        opts = POST_STREAMS[label][1]
        want = expected_launches(opts)
        print(f"post {label}: launches {launches}, kernel 2 out "
              f"{k2_outs}", flush=True)
        if launches != want or (want["restore_and_output"] and
                                k2_outs != ["f32"]):
            raise AssertionError(f"post {label}: launches {launches} (kernel "
                                 f"2 out {k2_outs}), expected {want}, f32")
    for label, (data, ref) in streams.items():
        check_post_decode(label, got[label], ref, POST_STREAMS[label][1])
    # each kernel against its twin on the main path's 4K inputs
    cfg, inp = prepared(streams["4k_rgba16_noise_pq"][0], dev)
    xyb = VarDCTFrame(cfg).reconstruct(inp, "f32")
    rnd = post.noise_random(cfg.crop_w, cfg.crop_h, dev)
    lut = torch.tensor(cfg.post.noise_lut, dtype=torch.float32, device=dev)
    note_post("add_noise", post.add_noise(xyb.clone(), rnd, lut),
              post.add_noise_plain(xyb.clone(), rnd, lut),
              "4k rgba16 noise pq stream")
    noised = post.add_noise(xyb.clone(), rnd, lut)
    spec = cfg.post.out
    note_a7(post.encode_output(noised, spec, 16),
            post.encode_output_plain(noised, spec, 16), "pq_2100",
            "4k rgba16 noise pq stream")
    for key in POST_SPECS:
        for bits in (8, 16):
            note_a7(post.encode_output(noised, post_spec(key), bits),
                    post.encode_output_plain(noised, post_spec(key), bits),
                    key, f"4k planes {bits}-bit")
    # views of the 4K planes that take 4 pixels a thread off the vector
    # paths: an odd base and a ragged row (scalar loads and stores), an
    # aligned base and a ragged row (16-byte loads, scalar stores)
    for view, what in ((noised[:, 1:2159, 3:3838], "cropped 3835x2158"),
                       (noised[:, :, :3837], "3837 of 3840 columns")):
        for key in ("srgb", "pq_2100"):
            note_a7(post.encode_output(view, post_spec(key), 16),
                    post.encode_output_plain(view, post_spec(key), 16), key,
                    f"4k planes, {what}, 16-bit")
    print("parity encode_output by spec, the largest code difference from "
          "the twin (rule 0; PQ by its limits): " + ", ".join(
              f"{k} {A7_MAX[k]}" for k in POST_SPECS), flush=True)
    ucfg, uinp = prepared(streams["4k_from_fhd_up2"][0], dev)
    planes = VarDCTFrame(ucfg).reconstruct(uinp, "f32")
    ker = post.kernels_for(2, ucfg.post.up_weights, dev)
    note_post("upsample", post.upsample(planes, ker),
              post.upsample_plain(planes, ker), "fhd planes of the up2 stream")
    for n in (4, 8):
        k = post.kernels_for(n, device=dev)
        small = planes[:, :540, :960]
        note_post("upsample", post.upsample(small, k),
                  post.upsample_plain(small, k), f"540x960 planes n {n}")
    layers = {label: post_layers(label, streams[label][0], 3840 * 2160 / 1e6,
                                 card)
              for label in ("4k_rgba16_noise_pq", "4k_from_fhd_up2")}
    post_timings({"add_noise": (xyb, rnd, lut), "upsample": (planes, ker),
                  "encode_output": (noised, spec, 16)}, card, ms)
    a7_launch_timings(a7_calls, counts["encode_output"], card)
    print(f"phase 12 (post stages) took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return dict(counts, layers=layers,
                streams={label: data for label, (data, _) in streams.items()})


# ---- api.decode_batch (phase 13) ----

# the kernels a batch of the phase's streams runs, each at least once
BATCH_KERNELS = ("synth_family", "synth_dct8", "restore_and_output",
                 "epf0_pass", "decode_pass_groups", "rct_inverse",
                 "add_noise", "upsample", "encode_output")
# what a batch on the card must not run: the kernels' plain twins
BATCH_TWINS = POST_TWINS + ((ENT, ("decode_pass_groups_plain",)),
                            (synth, ("synth_family_plain",)))


@contextlib.contextmanager
def batch_spans(log: list):
    """Log, per call, (name, start, end, thread CPU seconds) of the host
    halves (api.host_half, on the workers or inside api.decode), the
    device halves (api.device_half: the uploads and the launches, queued
    on the main thread) and the main thread's own steps of a batch: a
    file's upload, device half and download queued (_Card.push) and the
    finished files' wait, copy out and orientation (_Card.done)."""
    saved = [(api, "host_half", api.host_half),
             (api, "device_half", api.device_half),
             (BATCH._Card, "push", BATCH._Card.push),
             (BATCH._Card, "done", BATCH._Card.done)]

    def spanned(fn, name):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return fn(*args, **kwargs)
            finally:
                log.append((name, t0, time.perf_counter(),
                            time.thread_time() - c0))
        return call

    for owner, name, fn in saved:
        setattr(owner, name, spanned(fn, name))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def device_busy(fn) -> tuple:
    """(the card's busy share of one call of fn, wall ms, device events
    seen): the union of the device's kernel, copy and memset intervals
    that torch.profiler records, over the call's wall time.  None for the
    share when the profiler saw no device event."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return (busy / 1e3 / wall if spans else None), wall, len(spans)


def timed_batch(datas, entropy: str) -> tuple:
    """(outputs, ms) of one api.decode_batch call, the garbage collector
    off."""
    torch.cuda.synchronize()
    with no_gc():
        t0 = time.perf_counter()
        outs = api.decode_batch(datas, "cuda", entropy)
        return outs, (time.perf_counter() - t0) * 1e3


def timed_sequence(datas, entropy: str) -> tuple:
    """(outputs, ms) of one api.decode call per file, in turn; the garbage
    collector off during each call, each call's time summed."""
    outs, total = [], 0.0
    for data in datas:
        torch.cuda.synchronize()
        with no_gc():
            t0 = time.perf_counter()
            outs.append(api.decode(data, "cuda", entropy)[0])
            total += (time.perf_counter() - t0) * 1e3
    return outs, total


def batch_timing(label: str, datas: list, entropy: str, card: str) -> None:
    """2 batch calls against 2 runs of N sequential api.decode calls, in
    turns (S B B S); the outputs of every call equal, code for code,
    to the first sequential run's (api.decode's).  Then the host halves
    alone and in the batch, the CPU used, the peak device memory and the
    card's busy share (one profiled batch call)."""
    med = statistics.median
    seq, bat, seq_logs, bat_logs, cpu, peaks = [], [], [], [], [], []
    ref = None
    for kind in "SBBS":
        log = []
        c0 = time.process_time()
        with batch_spans(log):
            if kind == "S":
                outs, t = timed_sequence(datas, entropy)
                seq.append(t)
                seq_logs.append(log)
                ref = ref if ref is not None else outs
            else:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                outs, t = timed_batch(datas, entropy)
                peaks.append(torch.cuda.max_memory_allocated() - base)
                bat.append(t)
                bat_logs.append(log)
                cpu.append((time.process_time() - c0) * 1e3)
        for k, (o, r) in enumerate(zip(outs, ref)):
            if o.shape != r.shape or o.dtype != r.dtype or \
                    not np.array_equal(o, r):
                raise AssertionError(f"batch {label}: file {k} differs from "
                                     f"api.decode's output")
    mp = sum(r.shape[0] * r.shape[1] for r in ref) / 1e6
    t_seq, t_bat = med(seq), med(bat)
    n, peak = len(datas), max(peaks)
    def total(logs, name, cpu=False):
        """The median over the calls of a span's time summed over the
        files (ms): wall, or its thread's CPU."""
        return med(sum((c if cpu else t1 - t0) for n, t0, t1, c in log
                       if n == name) * 1e3 for log in logs)

    host_alone, host_in = total(seq_logs, "host_half"), total(bat_logs,
                                                             "host_half")
    host_cpu_alone = total(seq_logs, "host_half", True)
    host_cpu_in = total(bat_logs, "host_half", True)
    dev_alone, dev_in = total(seq_logs, "device_half"), total(bat_logs,
                                                            "device_half")
    dev_cpu_alone = total(seq_logs, "device_half", True)
    dev_cpu_in = total(bat_logs, "device_half", True)
    push, finish = total(bat_logs, "push"), total(bat_logs, "done")
    busy, wall, events = device_busy(lambda: api.decode_batch(
        datas, "cuda", entropy))
    busy_s = "not measured (no device events)" if busy is None else \
        f"{busy:.2%}"
    print(f"batch {label} ({n} files, {mp:.2f} MP, entropy={entropy}, "
          f"{BATCH.WORKERS} workers, {BATCH.IN_FLIGHT} in flight): batch "
          f"{t_bat:.1f} ms = {mp / t_bat * 1e3:.2f} MP/s (calls "
          f"{', '.join(f'{t:.1f}' for t in bat)}); sequential api.decode "
          f"{t_seq:.1f} ms = {mp / t_seq * 1e3:.2f} MP/s (runs "
          f"{', '.join(f'{t:.1f}' for t in seq)}); batch / sequential "
          f"MP/s {t_seq / t_bat:.3f}x; outputs equal to api.decode's (0 "
          f"codes) [{card}]", flush=True)
    print(f"batch {label} split: host halves alone (inside the sequential "
          f"calls) {host_alone:.1f} ms summed over the files, their thread "
          f"CPU {host_cpu_alone:.1f} ms; in the batch {host_in:.1f} ms summed"
          f" over the files on the workers (overlap: {host_in / t_bat:.2f} "
          f"host halves at a time), their thread CPU {host_cpu_in:.1f} ms; "
          f"the process's CPU {med(cpu):.1f} ms over the batch's "
          f"{t_bat:.1f} ms wall ({med(cpu) / t_bat:.2f} cores); device "
          f"halves (uploads and launches queued) alone {dev_alone:.1f} ms, "
          f"thread CPU {dev_cpu_alone:.1f} ms; in the batch {dev_in:.1f} ms, "
          f"thread CPU {dev_cpu_in:.1f} ms; the main thread queued the "
          f"files' upload, device half and download in {push:.1f} ms and "
          f"finished them (wait, copy out, orientation) in {finish:.1f} ms; "
          f"peak device memory over what the process held "
          f"before {peak / 2**20:.1f} MiB; the card busy {busy_s} of one "
          f"profiled batch call ({wall:.1f} ms, {events} device events) "
          f"[{card}]", flush=True)


def batch_phase(vardct: dict, modular: dict, posted: dict,
                card: str) -> None:
    """Phase 13: api.decode_batch.  The batches once, counted, the twins
    made to raise, each output equal to api.decode's; then each batch
    timed against sequential api.decode calls, at the pipeline's own
    worker count and files in flight (batch.WORKERS, IN_FLIGHT; their
    sweeps are no longer run, PERF.md §4)."""
    t_phase = time.perf_counter()
    k4 = vardct["4k_d1.0_e7"][2]
    batches = {
        "8x 4k d1.0 e7 host": ([k4] * 8, "host"),
        "8x 4k d1.0 e7 device": ([k4] * 8, "device"),
        "mixed host": ([k4, posted["4k_rgba16_noise_pq"],
                        posted["4k_from_fhd_up2"], modular["4k_rct"],
                        vardct["fhd_d4.0_e7"][2],
                        vardct["16bit_d1.0_e5"][2]], "host")}

    def main_path():
        return {label: api.decode_batch(datas, "cuda", entropy)
                for label, (datas, entropy) in batches.items()}

    with contextlib.ExitStack() as stack:
        for module, names in BATCH_TWINS:
            stack.enter_context(forbidden(module, names))
        _, counts = drive("main path (api.decode_batch)", main_path,
                          BATCH_KERNELS)
    if counts["decode_pass_groups"] != 8:
        raise AssertionError(f"the device-route batch launched the entropy "
                             f"kernel {counts['decode_pass_groups']} times "
                             f"for 8 files")
    for label, (datas, entropy) in batches.items():
        batch_timing(label, datas, entropy, card)
    print(f"phase 13 (decode_batch) took {time.perf_counter() - t_phase:.1f}"
          f" s", flush=True)


# ---- patches, splines, reference-only and LF frames (phase 14) ----

OVERLAY_KERNELS = ("overlay_patches", "draw_splines")
# what a decode of these streams on the card must not run: every plain
# twin of its path
OVERLAY_TWINS = POST_TWINS + (
    (OV, ("overlay_patches_plain", "draw_splines_plain",
          "spline_sums_plain")),
    (ENT, ("decode_pass_groups_plain",)))
# the writers' sources: a change to any of them re-encodes
OVERLAY_WRITER = POST_WRITER + [importlib.import_module(m).__file__ for m in (
    "jxl_coder_tpu_torch.host.vardct.enc_patches",
    "jxl_coder_tpu_torch.host.vardct.splines")]
F64_OPS_PER_S = 34e12         # fp64 outside the tensor cores, H100 SXM
# the least fp64 operations of the spline sums: per (point, pixel) pair of
# a blob's box, the product ey * ex, its scale, three colour products and
# three sums (8); per (point, column) and (point, row) of the box, one erf
# difference: two erfs, each the argument ((i +- 0.5) - c) * inv (3), |x|
# and the sign's product (1), tt = 1 / (1 + a |x|) (3), the polynomial's
# five products and four sums (9), -|x| * |x| (1), exp (counted as 1), the
# products by tt and exp and 1 - (3): 21; and the difference (1): 43
SPLINE_OPS = {"pair": 8, "erf_diff": 43}


def text_alpha(h: int, w: int) -> np.ndarray:
    return (np.mgrid[0:h, 0:w][1] * 255 // max(w - 1, 1)).astype(np.uint8)


def overlay_data(label: str) -> bytes:
    """The stream of one OVERLAY_STREAMS entry (encodes cached)."""
    if label == "4k_text":
        # the bytes of reference.encode_vardct(img, distance=1.0, effort=7)
        # (tests/test_torch_patches.py holds them equal at 192x256), without
        # the frame it encodes beside the detector and drops on a hit
        from jxl_coder_tpu_torch.host.vardct import enc_patches, enc_real
        img = text_frame(2160, 3840)
        return cached(img, "text d1.0 e7 (patches)", OVERLAY_WRITER,
                      lambda: enc_real._encode_with_patches(
                          img, enc_patches.detect(img), distance=1.0,
                          effort=7))
    k4 = stream(bench_frame(2160, 3840), 1.0, 7)
    if label == "4k_splines":
        return with_splines(k4, seeded_splines(2160, 3840, 64))
    if label == "4k_lf":
        return with_lf_frame(k4)
    if label == "vardct_reference":
        return vardct_reference_still(bench_frame(256, 384))
    img = text_frame(384, 512)
    return cached(img, "patched alpha", OVERLAY_WRITER,
                  lambda: patched_alpha_still(img, text_alpha(384, 512)))


# label: per route, the launches of its decode (kernel 2's outs in order)
OVERLAY_STREAMS = {
    "4k_text": dict(overlay_patches=1, draw_splines=0, encode_output=1,
                    k2=["f32"]),
    "4k_splines": dict(overlay_patches=0, draw_splines=1, encode_output=1,
                       k2=["f32"]),
    "4k_lf": dict(overlay_patches=0, draw_splines=0, encode_output=0,
                  k2=["u8"]),
    # the reference frame's own kernel 2 pass, then the frame's
    "vardct_reference": dict(overlay_patches=1, draw_splines=0,
                             encode_output=1, k2=["f32", "f32"]),
    "patched_alpha": dict(overlay_patches=1, draw_splines=0,
                          encode_output=1, k2=["f32"]),
}


def overlay_job(label: str):
    """In a worker process: the stream and its float64 host decode ->
    (bytes, pixels, seconds to write, seconds to decode)."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    data = overlay_data(label)
    t1 = time.perf_counter()
    ref = reference.decode_float64(data)
    return data, ref, t1 - t0, time.perf_counter() - t1


def routes_of(label: str) -> tuple:
    # a frame with extra channels: the host route (the device route raises)
    return ("host",) if label == "patched_alpha" else ("host", "device")


OVERLAY_LAYERS = {
    "walk + LF/ref frames' host decode": ("_read_frames", "before host"),
    "main parse": ("parse_frame",),
    "overlay lists (PostConfig.of)": ("PostConfig.of",),
    "pack": ("pack",),
    "h2d": ("from_prepared",),
    "LF/ref frames' device work": ("_device_before",),
    "synthesis + kernel 2": ("reconstruct",),
    "A8 patches": ("overlay_patches",),
    "A9 splines": ("draw_splines",),
    "rest of post (A5-A7)": ("add_noise", "upsample", "encode_output"),
    "d2h": ("d2h",),
    "rest (host_half, device_half, frame, orientation, info)": (
        "host_half", "main host", "device_half", "frame",
        "apply_orientation", "basic_info"),
}


@contextlib.contextmanager
def split_overlay(log: list):
    """Wrap the functions an api.decode of these streams calls (the device
    steps synchronise in their wrappers); restore them on exit."""
    from jxl_coder_tpu_torch.vardct import frame as FRAME
    saved = []

    def wrap(owner, name, wrapper):
        saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, wrapper)

    for name in ("_read_frames", "parse_frame", "pack", "from_prepared",
                 "apply_orientation", "basic_info", "host_half"):
        wrap(api, name, tspan(getattr(api, name), name, log))
    wrap(api, "device_half", tspan(api.device_half, "device_half", log,
                                   sync=True))
    wrap(api, "_device_before", tspan(api._device_before, "_device_before",
                                      log, sync=True))
    host_one = api._host_one

    def named_host_one(*args, xyb=False, **kwargs):
        return tspan(host_one, "before host" if xyb else "main host",
                     log)(*args, xyb=xyb, **kwargs)
    wrap(api, "_host_one", named_host_one)
    wrap(api, "PostConfig", type("PostConfig", (), {"of": staticmethod(
        tspan(api.PostConfig.of, "PostConfig.of", log))}))
    for name in ("add_noise", "upsample", "encode_output"):
        wrap(post, name, tspan(getattr(post, name), name, log, sync=True))
    for name in OVERLAY_KERNELS:
        wrap(OV, name, tspan(getattr(OV, name), name, log, sync=True))
    wrap(FRAME.VarDCTFrame, "reconstruct",
         tspan(FRAME.VarDCTFrame.reconstruct, "reconstruct", log, sync=True))
    real = FRAME.VarDCTFrame

    class Frame:
        def __init__(self, cfg):
            self.frame = real(cfg)

        def xyb(self, frame_inputs):
            return self.frame.xyb(frame_inputs)

        def __call__(self, frame_inputs):
            px = tspan(self.frame, "frame", log, sync=True)(frame_inputs)
            return PixelsT(px, log)

    wrap(api, "VarDCTFrame", Frame)
    try:
        yield
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


def overlay_layers(label: str, data: bytes, card: str, runs: int = 3
                   ) -> dict:
    """M1 for one 4K stream (host entropy route): `runs` split api.decode
    calls in turns with as many unwrapped ones; raises if a split call's
    layers miss its own total by more than 2%."""
    med = statistics.median
    split, unsplit = [], []
    for i in range(2 * runs):
        torch.cuda.synchronize()
        if (i % 2 == 0) == (i // 2 % 2 == 0):
            log = []
            with split_overlay(log), no_gc():
                t0 = time.perf_counter()
                api.decode(data, device="cuda")
                split.append(((time.perf_counter() - t0) * 1e3, log))
        else:
            with no_gc():
                t0 = time.perf_counter()
                api.decode(data, device="cuda")
                unsplit.append((time.perf_counter() - t0) * 1e3)
    per = {k: [] for k in OVERLAY_LAYERS}
    for total, log in split:
        own, _other = exclusive_ms(log)
        for k, names in OVERLAY_LAYERS.items():
            per[k].append(sum(own.get(n, 0.0) for n in names))
    sums = [sum(v[n] for v in per.values()) for n in range(len(split))]
    gaps = [abs(sums[n] - total) / total for n, (total, _) in enumerate(split)]
    for n, (total, _) in enumerate(split):
        if gaps[n] > 0.02:
            raise AssertionError(f"split decode {label} {n}: its layers sum "
                                 f"to {sums[n]:.1f} ms, the call took "
                                 f"{total:.1f} ms")
    m = {k: med(v) for k, v in per.items()}
    t_unsplit = med(unsplit)
    print(f"layers {label} (host clock, ms, median of {runs} split "
          f"api.decode calls, host route): " + ", ".join(
              f"{k} {v:.3f}" for k, v in m.items())
          + f"; each call's layers summed, median {med(sums):.1f}, within "
          f"{max(gaps):.2%} of the call's own total; the split calls' total "
          f"{med(t for t, _ in split):.1f}; unsplit calls {t_unsplit:.1f} "
          f"[{card}]", flush=True)
    print(f"end_to_end {label} decode bytes->pixels (the unsplit calls): "
          f"{t_unsplit:.1f} ms = {3840 * 2160 / 1e6 / t_unsplit * 1e3:.2f} "
          f"MP/s [{card}]", flush=True)
    return dict(m, total=t_unsplit)


def lf_global_of(data: bytes):
    """The frame to decode's LfGlobal, read again on the host (its patch
    dictionary and splines)."""
    from jxl_coder_tpu_torch.host.bitstream.reader import BitReader
    from jxl_coder_tpu_torch.host.vardct.dec_real import read_lf_global
    cs, hdr, fh, toc = api._read_frame(data)
    s = toc.section(0)
    w, h = fh.coded_size(hdr)
    return read_lf_global(BitReader(cs[s.offset:s.offset + s.size]), fh,
                          hdr, w, h), h, w


def overlay_inputs(data: bytes, dev):
    """The main path's inputs of A8 / A9 for a stream: the frame's filtered
    planes (kernel 2's f32 out), its overlay lists and reference planes on
    the card."""
    cfg, inp = prepared(data, dev)
    xyb = VarDCTFrame(cfg).reconstruct(inp, "f32").contiguous()
    return cfg, inp, xyb


def check_overlay_kernels(label: str, data: bytes, dev) -> tuple:
    """A8 and A9 against their twins on a stream's main-path inputs: A8
    bit for bit (one f32 operation a blend, in the same order), A9 within
    1e-6 (fp64 sums in the same order; CUDA's exp and torch's may differ in
    the last bit)."""
    cfg, inp, xyb = overlay_inputs(data, dev)
    ov = inp.overlay
    if ov.patches is not None:
        a = OV.overlay_patches(xyb.clone(), inp.refs, ov.patches,
                               *ov.patch_tiles)
        b = OV.overlay_patches_plain(xyb.clone(), inp.refs, ov.patches)
        note_err("overlay_patches", (a - b).abs().max().item(), 0.0,
                 f"{label} planes ({ov.patches.shape[0]} patches, "
                 f"{(a != xyb).sum().item()} values changed, "
                 f"{ov.patch_tiles[0].numel()} tiles)")
    if ov.points is not None:
        a = OV.draw_splines(xyb.clone(), ov.points, ov.boxes,
                            *ov.point_tiles)
        b = OV.draw_splines_plain(xyb.clone(), ov.points, ov.boxes)
        note_err("draw_splines", (a - b).abs().max().item(), 1e-6,
                 f"{label} planes ({ov.points.shape[0]} points, "
                 f"{(a != b).sum().item()} values not bit-equal, "
                 f"{(a != xyb).sum().item()} changed, "
                 f"{ov.point_tiles[0].numel()} tiles)")
        refuses_unaligned("draw_splines", lambda boxes: OV.draw_splines(
            xyb.clone(), ov.points, boxes, *ov.point_tiles), ov.boxes)
    return cfg, inp, xyb


def overlay_timings(streams: dict, dev, card: str, ms: dict) -> None:
    """A8 on the 4K text's planes and A9 on the 4K splines' by CUDA graph,
    against the twin (one call, events), the bound, and the JAX route's
    equivalent as one PyTorch expression: dense (3, H, W) mul / add planes
    built on the host (patches_to_affine; Splines.render cast to f32 into
    add), uploaded, then x * mul + add (the upload timed apart)."""
    from jxl_coder_tpu_torch.host.vardct.patches import patches_to_affine
    for name, label in (("overlay_patches", "4k_text"),
                        ("draw_splines", "4k_splines")):
        data = streams[label][0]
        cfg, inp, xyb = overlay_inputs(data, dev)
        ov = inp.overlay
        lf, h, w = lf_global_of(data)
        host = cfg.post.overlay
        if name == "overlay_patches":
            drawn = host.drawn
            area = int((drawn[:, 2].astype(np.int64) * drawn[:, 3]).sum())
            note_bound(name, area * 3 * 12, 0)
            kernel = lambda: OV.overlay_patches(xyb, inp.refs, ov.patches,
                                                *ov.patch_tiles)
            twin = lambda: OV.overlay_patches_plain(xyb.clone(), inp.refs,
                                                    ov.patches)
            refs = {s: list(r.cpu().numpy()) for s, r in inp.refs.items()}
            mul, add = patches_to_affine(lf.patches, h, w, refs)
            what = f"{len(drawn)} patches, {area} patch pixels"
        else:
            b = host.boxes.astype(np.int64)
            cols, rows = b[:, 1] - b[:, 0] + 1, b[:, 3] - b[:, 2] + 1
            pairs = int((cols * rows).sum())
            mask = np.zeros((h, w), bool)
            for x0, x1, y0, y1 in b.tolist():
                mask[y0:y1 + 1, x0:x1 + 1] = True
            touched = int(mask.sum())
            ops = pairs * SPLINE_OPS["pair"] + int(
                (cols + rows).sum()) * SPLINE_OPS["erf_diff"]
            note_bound(name, touched * 3 * 8 + len(b) * (56 + 16), ops,
                       F64_OPS_PER_S, "fp64")
            kernel = lambda: OV.draw_splines(xyb, ov.points, ov.boxes,
                                             *ov.point_tiles)
            twin = lambda: OV.draw_splines_plain(xyb.clone(), ov.points,
                                                 ov.boxes)
            cf = 1.0 / lf.cfl_color_factor
            planes = [np.zeros((h, w)) for _ in range(3)]
            lf.splines.render(planes,
                              base_cx=lf.cfl_base_x + lf.cfl_ytox_dc * cf,
                              base_cb=lf.cfl_base_b + lf.cfl_ytob_dc * cf)
            mul = np.ones((3, h, w), np.float32)
            add = np.stack(planes).astype(np.float32)
            what = (f"{len(b)} points, {pairs} point-pixel pairs, {touched} "
                    f"pixels touched")
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        dmul = torch.from_numpy(mul).to(dev)
        dadd = torch.from_numpy(add).to(dev)
        t1.record()
        t1.synchronize()
        h2d = t0.elapsed_time(t1)
        LIBRARY_MS[name] = graph_ms(lambda: xyb * dmul + dadd)
        ms[name] = (graph_ms(kernel), once_ms(twin))
        print(f"kernel {name} at 4k on the {label} stream ({what}): device "
              f"{ms[name][0]:.4f} ms (CUDA graph), plain twin "
              f"{ms[name][1]:.1f} ms, bound {BOUND[name][0]:.4f} ms "
              f"({BOUND[name][1]}); the JAX route's application of planes "
              f"the host rendered, dense x * mul + add (it renders nothing) "
              f"{LIBRARY_MS[name]:.4f} ms (CUDA graph) after uploading its "
              f"{(mul.nbytes + add.nbytes) / 1e6:.1f} MB of planes in "
              f"{h2d:.2f} ms [{card}]", flush=True)
        if name == "draw_splines":
            ptxas_report("overlay", only="splines_kernel")


def overlay_phase(jobs: dict, vardct: dict, modular: dict, dev, card: str,
                  ms: dict) -> dict:
    """Phase 14: patches, splines, reference-only and LF frames.  The main
    path through api.decode(data, "cuda") on every stream and entropy
    route, counted, the twins made to raise, each decode against the
    float64 host decoder; A8 and A9 against their twins on the main path's
    planes; M1 for the three 4K streams; timings; a mixed decode_batch."""
    t_phase = time.perf_counter()
    streams = {}
    for label, job in jobs.items():
        data, ref, t_write, t_ref = job.get()
        streams[label] = (data, ref)
        print(f"overlay stream {label}: {len(data)} bytes, frames "
              f"{[(fh.frame_type, fh.encoding, fh.flags) for fh, _ in api._read_frames(data)[2]]}"
              f"; written in {t_write:.1f} s, its float64 host decode "
              f"{t_ref:.1f} s (a worker process)", flush=True)
    host = api.host_half(streams["4k_text"][0], dev)
    atlas = host.before[0].host.planes.image.channels[0]
    print(f"4k text: {host.post.overlay.patches.shape[0]} patches of "
          f"{len(np.unique(host.post.overlay.patches[:, 5:7], axis=0))} "
          f"atlas rectangles; the reference frame {atlas.width}x"
          f"{atlas.height}; {len(streams['4k_text'][0])} bytes", flush=True)
    path = OVERLAY_KERNELS + ("encode_output", "restore_and_output")
    outs2 = []

    def main_path():
        got, per = {}, {}
        for label, (data, _ref) in streams.items():
            for entropy in routes_of(label):
                before = {k: KERNELS[k]["fn"].launches
                          for k in path + MODULAR_KERNELS}
                del outs2[:]
                got[label, entropy] = api.decode(data, device="cuda",
                                                 entropy=entropy)[0]
                per[label, entropy] = (
                    {k: KERNELS[k]["fn"].launches - before[k]
                     for k in path + MODULAR_KERNELS}, list(outs2))
        return got, per

    with contextlib.ExitStack() as stack:
        stack.enter_context(kernel2_outs(outs2))
        for module, names in OVERLAY_TWINS:
            stack.enter_context(forbidden(module, names))
        (got, per), counts = drive("main path (patches, splines, LF and "
                                   "reference frames)", main_path, path)
    for (label, entropy), (launches, k2) in per.items():
        want = OVERLAY_STREAMS[label]
        print(f"overlay {label} {entropy}: launches {launches}, kernel 2 out "
              f"{k2}", flush=True)
        bad = [k for k in OVERLAY_KERNELS + ("encode_output",)
               if launches[k] != want[k]]
        if bad or k2 != want["k2"] or \
                launches["restore_and_output"] != len(want["k2"]) or \
                any(launches[k] for k in MODULAR_KERNELS):
            raise AssertionError(f"overlay {label} {entropy}: launches "
                                 f"{launches}, kernel 2 {k2}; expected "
                                 f"{want} and no Modular transform")
    try:
        api.decode(streams["patched_alpha"][0], device="cuda",
                   entropy="device")
        raise AssertionError("patched_alpha: entropy='device' decoded a "
                             "frame with extra channels")
    except NotImplementedError:
        pass
    for label, (data, ref) in streams.items():
        routes = routes_of(label)
        for entropy in routes:
            out = got[label, entropy]
            within_one_code(out[..., :3], ref[..., :3],
                            f"decode {label} {entropy} vs the float64 host "
                            f"decoder")
            if not np.array_equal(out[..., 3:], ref[..., 3:]):
                raise AssertionError(f"{label}: extra channels differ")
        if len(routes) == 2 and not np.array_equal(got[label, "host"],
                                                   got[label, "device"]):
            raise AssertionError(f"{label}: the entropy routes differ")
    for label, (data, _ref) in streams.items():
        if label != "4k_lf":
            check_overlay_kernels(label, data, dev)
    layers = {label: overlay_layers(label, streams[label][0], card)
              for label in ("4k_text", "4k_splines", "4k_lf")}
    overlay_timings(streams, dev, card, ms)
    # decode_batch: the three 4K streams with the 4K d1.0 e7 frame and the
    # 4K Modular RCT still
    datas = [streams[k][0] for k in ("4k_text", "4k_splines", "4k_lf")] + [
        vardct["4k_d1.0_e7"][2], modular["4k_rct"]]
    with contextlib.ExitStack() as stack:
        for module, names in OVERLAY_TWINS:
            stack.enter_context(forbidden(module, names))
        t0 = time.perf_counter()
        outs = api.decode_batch(datas, "cuda")
        t_batch = (time.perf_counter() - t0) * 1e3
    singles = [got[k, "host"] for k in ("4k_text", "4k_splines", "4k_lf")] + [
        api.decode(d, device="cuda")[0] for d in datas[3:]]
    for i, (a, b) in enumerate(zip(outs, singles)):
        if not np.array_equal(a, b):
            raise AssertionError(f"decode_batch datas[{i}] differs from "
                                 f"decode")
    print(f"batch 4k text + splines + LF + d1.0 e7 + Modular RCT (host "
          f"route): one call {t_batch:.1f} ms, every output equal to "
          f"api.decode's [{card}]", flush=True)
    print(f"phase 14 (patches, splines, LF and reference frames) took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(counts, layers=layers,
                streams={label: data for label, (data, _) in streams.items()})


# ---- the sampled decode (phase 15) ----

SAMPLED_KERNELS = ("encode_output_down", "box_codes", "rescale_image",
                   "convert")
# what a sampled decode on the card must not run: every plain twin of its
# path
SAMPLED_TWINS = OVERLAY_TWINS + (
    (post, ("encode_output_down_plain", "pool_plain")),
    (SAMPLE, ("box_codes_plain",)),
    (RESIZE, ("rescale_image_plain", "resize_plane_stack_plain")),
    (PACK, ("convert_plain", "unpack_plain")),
    (TONE, ("sdr_codes_plain",)))
FIT, FILL = int(api.ScaleMode.FIT), int(api.ScaleMode.FILL)
RESIZE_MODE = int(api.ScaleMode.RESIZE)
# target: (width, height, scale mode) of decode_sampled on the 4K streams
SAMPLED_TARGETS = {"thumbnail 480x270": (480, 270, FIT),
                   "quarter 960x540": (960, 540, FIT),
                   "fhd 1920x1080 FIT": (1920, 1080, FIT),
                   "1000x1000 FILL": (1000, 1000, FILL)}
SAMPLED_CONFIGS = tuple(int(c) for c in api.PreferredColorConfig)
RGBA_8888 = int(api.PreferredColorConfig.RGBA_8888)


def sampled_configs(target: str) -> tuple:
    """Every colour config at the thumbnail (S4 in each of its modes, on
    the DC image's codes); RGBA_8888 at the other targets, whose calls
    are full or quarter decodes (every config there took ~35 s)."""
    return (SAMPLED_CONFIGS if target == next(iter(SAMPLED_TARGETS))
            else (RGBA_8888,))
# the kernels whose launches each sampled call is held to
SAMPLED_WATCH = SAMPLED_KERNELS + ("restore_and_output", "encode_output",
                                   "synth_family", "synth_dct8",
                                   "rct_inverse")
# least operations per output value: S1 (down 4) the 16-term sums of three
# planes and their means (3 x 17) and the sRGB output (69); S2 the 64-term
# sum and the rounding (4); S4 the division (1 a channel), the packing's
# multiply, round and clamp (4 a channel); S3 counts its bands' taps
SAMPLED_OPS = {"encode_output_down": 3 * 17 + 69, "box_codes": 68,
               "convert": 5 * 4}


def sampled_expect(label: str, target: str) -> tuple:
    """(route, the launches each call of it makes): the thumbnail of a
    VarDCT frame its DC (kernel 2's output step, or A7 for PQ; no
    synthesis, no pass group), of the Modular still a full decode and S2;
    the quarter route S1 for the one eligible stream (the others decode
    whole); a target other than the decoded size S3; S4 always."""
    vardct, pq = label != "4k_rct", label == "4k_rgba16_noise_pq"
    if target.startswith("thumbnail"):
        route = "thumbnail" if vardct else "full + S2"
    elif target.startswith("quarter") and label == "4k_d1.0_e7":
        route = "quarter"
    else:
        route = "full"
    want = dict(encode_output_down=int(route == "quarter"),
                box_codes=int(route == "full + S2"),
                rescale_image=int(route == "full"), convert=1)
    if route == "thumbnail":
        want.update(synth_family=0, synth_dct8=0, rct_inverse=0,
                    restore_and_output=int(not pq), encode_output=int(pq),
                    read_pass_group=0)
    elif route == "quarter":
        want.update(restore_and_output=1, encode_output=0)
    return route, want


@contextlib.contextmanager
def recorded(calls: dict, current: list):
    """Record the first call of each of S1-S4 per (stream, target) (S4:
    per colour config too) on the sampled path: its arguments and output."""
    saved = []

    def wrap(owner, name, key_len):
        orig = getattr(owner, name)

        @functools.wraps(orig)
        def call(*args, **kwargs):
            before = call.launches
            out = orig(*args, **kwargs)
            # a wrapper that replaces the kernel's own module name takes
            # the count orig adds through that name: hand it back
            orig.launches += call.launches - before
            calls.setdefault((name,) + tuple(current[:key_len]),
                             (args, kwargs, out))
            return out
        saved.append((owner, name, orig))
        setattr(owner, name, call)

    wrap(post, "encode_output_down", 2)
    wrap(api, "box_codes", 2)
    wrap(api, "rescale_image", 2)
    wrap(PACK, "convert", 3)
    try:
        yield
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


@contextlib.contextmanager
def counted(owner, name: str, count: list):
    """owner.name, counting its calls in count[0]."""
    orig = getattr(owner, name)

    def call(*args, **kwargs):
        count[0] += 1
        return orig(*args, **kwargs)
    setattr(owner, name, call)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def packed_fields(t: torch.Tensor) -> torch.Tensor:
    """A packed output's fields as float64 codes (F16: the values x 2048)."""
    if t.dtype in (torch.uint16, torch.uint32):
        v = t.to(torch.int64)
        if t.dtype == torch.uint16:
            return torch.stack([(v >> 11) & 31, (v >> 5) & 63, v & 31],
                               -1).double()
        return torch.stack([v & 1023, (v >> 10) & 1023, (v >> 20) & 1023,
                            (v >> 30) & 3], -1).double()
    if t.dtype == torch.float16:
        return t.double() * 2048
    return t.double()


def check_sampled_kernels(calls: dict) -> None:
    """Each kernel's main-path calls against its twin on the same inputs:
    S1 and S3 within 1 code (S3 on an image with unassociated alpha: its
    colour times alpha, within 1 code and the float32 difference of the
    two sums times maxv, 1.02), S2 equal, S4 equal (within 1 field code
    where it tone-maps: the transfer functions' powf and expf are CUDA's
    in the kernel and glibc's in the twin)."""
    twins = {"encode_output_down": post.encode_output_down_plain,
             "box_codes": SAMPLE.box_codes_plain,
             "rescale_image": RESIZE.rescale_image_plain,
             "convert": PACK.convert_plain}
    worst = {}
    for key, (args, kwargs, out) in calls.items():
        name = key[0]
        ref = twins[name](*args, **kwargs)
        if ref.shape != out.shape or ref.dtype != out.dtype:
            raise AssertionError(f"{key}: {tuple(out.shape)} {out.dtype} vs "
                                 f"the twin's {tuple(ref.shape)} {ref.dtype}")
        fields = packed_fields if name == "convert" else torch.Tensor.double
        diff = (fields(out) - fields(ref)).abs()
        tone = name == "convert" and len(args) > 2 and args[2] is not None
        premultiplied = (args[5] if len(args) > 5
                         else kwargs.get("premultiplied", False))
        alpha = (name == "rescale_image" and out.shape[-1] in (2, 4)
                 and not premultiplied)
        if alpha:
            # unassociated alpha: the colour is divided by the filtered
            # alpha, which multiplies the two sums' float32 difference by
            # 1 / alpha; held as colour x alpha (the premultiplied colour
            # the filter computes), alpha itself as it is
            a = ref[..., -1:].double() / RESIZE._DTYPES[ref.dtype][1]
            diff = torch.cat([diff[..., :-1] * a, diff[..., -1:]], -1)
        d = diff.max().item()
        group = key[:3] + (tone,)
        what = (f"{tuple(args[0].shape)} {args[0].dtype}"
                + (" (tone map)" if tone else "")
                + (" (colour x alpha)" if alpha else ""))
        worst[group] = max(worst.get(group, (0.0, what)), (d, what))
    for (name, label, target, tone), (d, what) in worst.items():
        # colour x alpha: 1 code, and the float32 difference times maxv
        tol = {"box_codes": 0, "convert": 1 if tone else 0}.get(
            name, 1.02 if "alpha" in what else 1)
        note_err(name, d, tol, f"the sampled path's {label} {target} {what}"
                 + (" (every colour config)" if name == "convert" else ""))


def check_thumbnails(streams: dict, calls: dict) -> None:
    """The thumbnail route's codes (S4's input) against the float64 host
    thumbnail (reference.thumbnail_float64, the JAX package's host
    computation): within 1 code on < 0.1%; PQ by its mean and 99.9th
    percentile (PQ_LIMITS), its max and share beyond 64 codes printed: the
    DC image's near-black values move a float32 conversion by up to ~100
    codes as the full frame's do (PQ_LIMITS' note), and the thumbnail holds
    64x fewer values, so a handful of them (1 of 43,740 at 720x1296 on the
    CPU) is above PQ_OVER_SHARE there."""
    thumbnail = next(iter(SAMPLED_TARGETS))
    for label, data in streams.items():
        key = ("convert", label, thumbnail, SAMPLED_CONFIGS[0])
        if label == "4k_rct":
            continue
        codes = calls[key][0][0].cpu().numpy()
        ref = reference.thumbnail_float64(data)
        what = f"thumbnail {label} vs the float64 host thumbnail"
        if label == "4k_rgba16_noise_pq":
            c = pq_codes(codes, ref)
            print(f"{what}: {pq_what(c)}", flush=True)
            if codes.shape != ref.shape or not (
                    c[0] < PQ_LIMITS[0] and c[1] <= PQ_LIMITS[1]):
                raise AssertionError(f"{what}: outside the PQ limits")
        else:
            within_one_code(codes, ref, what)


SAMPLED_LAYERS = {
    "host half (parse, pack)": ("host_half", "_dc_host",
                                "_quarter_eligible"),
    "device half (h2d, kernels; synchronised)": ("device_half",
                                                 "_dc_device"),
    "S2 box": ("box_codes",),
    "S3 rescale": ("rescale_image",),
    "S4 reformat": ("reformat",),
    "d2h": ("d2h",),
    "rest (headers, orientation)": ("basic_info", "parse_header", "orient"),
}


@contextlib.contextmanager
def split_sampled(log: list):
    """Wrap the functions api.decode_sampled calls (the device steps
    synchronise in their wrappers; S4's output's .cpu().numpy() logs
    d2h); restore them on exit."""
    saved = []

    def wrap(owner, name, wrapper):
        saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, wrapper)

    device = ("device_half", "_dc_device", "box_codes", "rescale_image")
    for names in SAMPLED_LAYERS.values():
        for name in names:
            if name not in ("d2h", "reformat"):
                wrap(api, name, tspan(getattr(api, name), name, log,
                                      sync=name in device))
    reformat = tspan(PACK.reformat, "reformat", log, sync=True)
    wrap(api, "PACK", type("Pack", (), {"reformat": staticmethod(
        lambda *a, **k: PixelsT(reformat(*a, **k), log))}))
    try:
        yield
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


def sampled_layers(label: str, data: bytes, card: str, runs: int,
                   targets) -> dict:
    """M1 for decode_sampled at `targets` (RGBA_8888): `runs` split calls
    in turns with as many unwrapped ones and as many api.decode calls on
    the same bytes; raises if a split call's layers miss its own total by
    more than 2%.  Returns the medians (ms) by target."""
    med = statistics.median
    out = {}
    for target in targets:
        w, h, mode = SAMPLED_TARGETS[target]
        split, unsplit, full = [], [], []

        def sampled():
            return api.decode_sampled(data, w, h, 2, mode, device="cuda")

        sampled()   # warm: the split calls time no first call's work
        for i in range(3 * runs):
            torch.cuda.synchronize()
            turn = i % 3 if i // 3 % 2 == 0 else 2 - i % 3
            with no_gc():
                t0 = time.perf_counter()
                if turn == 0:
                    log = []
                    with split_sampled(log):
                        t0 = time.perf_counter()
                        sampled()
                        split.append(((time.perf_counter() - t0) * 1e3, log))
                elif turn == 1:
                    sampled()
                    unsplit.append((time.perf_counter() - t0) * 1e3)
                else:
                    api.decode(data, device="cuda")
                    full.append((time.perf_counter() - t0) * 1e3)
        per = {k: [] for k in SAMPLED_LAYERS}
        for total, log in split:
            own, _other = exclusive_ms(log)
            for k, names in SAMPLED_LAYERS.items():
                per[k].append(sum(own.get(n, 0.0) for n in names))
        sums = [sum(v[n] for v in per.values()) for n in range(len(split))]
        gaps = [abs(sums[n] - t) / t for n, (t, _) in enumerate(split)]
        if max(gaps) > 0.02:
            raise AssertionError(f"split sampled decode {label} {target}: its "
                                 f"layers miss the call's total by "
                                 f"{max(gaps):.2%}")
        m = {k: med(v) for k, v in per.items()}
        t_s, t_u, t_d = med(t for t, _ in split), med(unsplit), med(full)
        print(f"layers sampled {label} {target} (host clock, ms, median of "
              f"{runs} split decode_sampled calls, RGBA_8888): "
              + ", ".join(f"{k} {v:.3f}" for k, v in m.items())
              + f"; each call's layers summed within {max(gaps):.2%} of its "
              f"total; split calls {t_s:.1f}; unsplit decode_sampled "
              f"{t_u:.1f}; api.decode on the same bytes {t_d:.1f} "
              f"(sampled / decode {t_u / t_d:.3f}) [{card}]", flush=True)
        out[target] = dict(m, total=t_u, decode=t_d)
    return out


def s3_case(img: torch.Tensor, tw: int, th: int, mode: int, fid: int,
            label: str, card: str) -> float:
    """S3's kernel on one input against its twin under the sampled parity
    rule (1 code; with unassociated alpha colour x alpha within 1.02), and
    its time by CUDA graph beside its bound, printed -> the time."""
    h, w, c = img.shape
    pl = RESIZE.HR.plan(h, w, tw, th, mode)
    bnd = RESIZE.bands(h, w, pl, fid, img.device)
    got = RESIZE.resample(img, pl, bnd)
    ref = RESIZE.rescale_image_plain(img, tw, th, mode, fid)
    d = (got.double() - ref.double()).abs()
    alpha = c in (2, 4)
    if alpha:
        a = ref[..., -1:].double() / RESIZE._DTYPES[ref.dtype][1]
        d = torch.cat([d[..., :-1] * a, d[..., -1:]], -1)
    note_err("rescale_image", d.max().item(), 1.02 if alpha else 1, label)
    bv = RESIZE.HR.band(h, pl.oh, fid, pl.y0, pl.ch)
    bh = RESIZE.HR.band(w, pl.ow, fid, pl.x0, pl.cw)
    taps = 2 * c * (int(bv.length.sum()) * w + int(bh.length.sum()) * pl.ch)
    b, by = bound_of(nbytes(img, got), taps)
    t = graph_ms(lambda: RESIZE.resample(img, pl, bnd))
    print(f"kernel rescale_image at {label}: device {t:.4f} ms (CUDA graph, "
          f"one launch), bound {b:.4f} ms ({by}) [{card}]", flush=True)
    return t


def tone_instructions(fmt: int, k: dict = SASS_NEEDED) -> int:
    """S4's SASS instructions a pixel with the PQ tone map (pixel_ops.cu
    tone_to_sdr), each call counted at k as in a7_instructions: the codes
    to [0, 1] (3 divisions), per channel PQ's inverse (two powf, a division
    and 6 more), the BT.2408 scale (the luma 5, a division and 3), the
    clamps (6), the primaries' mix (15), per channel the sRGB step (a powf
    and 6) and its code (4); a packed format (fmt > 0) divides the four
    values by the code maximum again and packs them (4 divisions and 4 x
    4)."""
    n = (3 * k["div"] + 3 * (2 * k["powf"] + k["div"] + 6) + 5 + k["div"] + 3
         + 6 + 15 + 3 * (k["powf"] + 6 + 4))
    return n + (4 * k["div"] + 16 if fmt else 0)


def sampled_timings(calls: dict, card: str, ms: dict) -> None:
    """S1-S4 at the main path's 4K shapes by CUDA graph against their twins
    (CUDA events) and bounds; S3 beside the dense float32 matrix pair."""
    thumb, quarter, fhd, _fill = SAMPLED_TARGETS
    args, kw, out = calls["encode_output_down", "4k_d1.0_e7", quarter]
    xyb = args[0]
    note_bound("encode_output_down", nbytes(xyb, out),
               out.numel() // 3 * SAMPLED_OPS["encode_output_down"])
    ms["encode_output_down"] = (
        graph_ms(lambda: post.encode_output_down(*args, **kw)),
        device_ms(lambda: post.encode_output_down_plain(*args, **kw)))
    shapes = {"encode_output_down": f"{tuple(xyb.shape)} f32 -> "
              f"{tuple(out.shape)} {out.dtype}"}
    args, kw, out = calls["box_codes", "4k_rct", thumb]
    note_bound("box_codes", nbytes(args[0], out),
               out.numel() * SAMPLED_OPS["box_codes"])
    ms["box_codes"] = (graph_ms(lambda: SAMPLE.box_codes(*args, **kw)),
                       device_ms(lambda: SAMPLE.box_codes_plain(*args, **kw)))
    shapes["box_codes"] = (f"{tuple(args[0].shape)} -> {tuple(out.shape)} "
                           f"{out.dtype}")
    args, kw, out = calls["rescale_image", "4k_d1.0_e7", fhd]
    img = args[0]
    h, w, c = img.shape
    pl, fid = RESIZE.HR.plan(h, w, *args[1:4]), args[4]
    bv = RESIZE.HR.band(h, pl.oh, fid, pl.y0, pl.ch)
    bh = RESIZE.HR.band(w, pl.ow, fid, pl.x0, pl.cw)
    taps = 2 * c * (int(bv.length.sum()) * w + int(bh.length.sum()) * pl.ch)
    note_bound("rescale_image", nbytes(img, out), taps)
    # the kernel's launch on the bands the wrapper uploads first
    bnd = RESIZE.bands(h, w, pl, fid, img.device)
    ms["rescale_image"] = (
        graph_ms(lambda: RESIZE.resample(img, pl, bnd)),
        device_ms(lambda: RESIZE.rescale_image_plain(*args, **kw)))
    # the library yardstick: the reference's two dense float32 products
    planes = (img.permute(2, 0, 1).float() / 255.0).contiguous()
    wy = torch.from_numpy(RESIZE.HR.resample_matrix(h, pl.oh, fid)).to(
        img.device)
    wx = torch.from_numpy(RESIZE.HR.resample_matrix(w, pl.ow, fid)).to(
        img.device)
    LIBRARY_MS["rescale_image"] = graph_ms(
        lambda: torch.matmul(torch.matmul(wy, planes), wx.T), n=10)
    shapes["rescale_image"] = (f"{tuple(img.shape)} {img.dtype} -> "
                               f"{tuple(out.shape)} Mitchell")
    # S3 on more of the plans the API makes, each held to the twin
    rgba = torch.cat([img, img[..., :1]], -1)
    t_rgba = s3_case(rgba, *args[1:5], "4K RGBA8 -> 1920x1080 Mitchell",
                     card)
    s3_case(torch.from_numpy(bench_frame(270, 480)).to(img.device), 3840,
            2160, RESIZE_MODE, int(api.ResizeFilter.CATMULL_ROM),
            "the 8x upscale 480x270 RGB8 -> 3840x2160 Catmull-Rom", card)
    s3_case(img, 480, 270, FIT, fid, "4K RGB8 -> FIT 480x270 Mitchell", card)
    planes4 = (rgba.permute(2, 0, 1).float() / 255.0).contiguous()
    t_dense4 = graph_ms(lambda: torch.matmul(torch.matmul(wy, planes4),
                                             wx.T), n=10)
    print(f"kernel rescale_image at 4k RGBA8 -> {pl.cw}x{pl.ch}: device "
          f"{t_rgba:.4f} ms (CUDA graph); the dense float32 matmul pair "
          f"{t_dense4:.4f} ms (TF32 off, "
          f"{2 * 4 * pl.oh * w * (h + pl.ow) / 1e9:.1f} GFLOP) [{card}]",
          flush=True)
    args, kw, out = calls["convert", "4k_d1.0_e7", fhd, 2]
    px = args[0].numel() // args[0].shape[-1]
    note_bound("convert", nbytes(args[0], out),
               px * 4 * SAMPLED_OPS["convert"] // 4)
    ms["convert"] = (graph_ms(lambda: PACK.convert(*args, **kw)),
                     device_ms(lambda: PACK.convert_plain(*args, **kw)))
    shapes["convert"] = (f"{tuple(args[0].shape)} {args[0].dtype} -> "
                         f"{tuple(out.shape)} {out.dtype}")
    codes = args[0]
    if codes.dtype == torch.uint8 and codes.shape[-1] == 3:
        # RGB8 -> RGBA8888 is the codes with an opaque alpha appended
        LIBRARY_MS["convert"] = graph_ms(
            lambda: torch.nn.functional.pad(codes, (0, 1), value=255))
    targs, tkw, tout = calls["convert", "4k_rgba16_noise_pq", fhd, 2]
    t_tone = graph_ms(lambda: PACK.convert(*targs, **tkw))
    t_tone_plain = device_ms(lambda: PACK.convert_plain(*targs, **tkw))
    tpx = targs[0].numel() // targs[0].shape[-1]
    tb = nbytes(targs[0], tout) / HBM_BYTES_PER_S * 1e3
    ti = tpx * tone_instructions(targs[1]) / SASS_PER_S * 1e3
    tissue = tone_instructions(targs[1], SASS_COMMON)
    print(f"kernel convert with the PQ tone map, {tuple(targs[0].shape)} "
          f"{targs[0].dtype} -> {tuple(tout.shape)} {tout.dtype}: device "
          f"{t_tone:.4f} ms (CUDA graph), plain twin {t_tone_plain:.4f} ms, "
          f"bound {max(tb, ti):.4f} ms ({'bytes' if tb >= ti else 'operations'}"
          f"; bytes {tb:.4f}, {tone_instructions(targs[1])} SASS "
          f"instructions a pixel needed {ti:.4f}); issued {tissue} a pixel "
          f"{tpx * tissue / SASS_PER_S * 1e3:.4f} [{card}]", flush=True)
    for k in SAMPLED_KERNELS:
        lib = LIBRARY_MS[k]
        print(f"kernel {k} at {shapes[k]}: device {ms[k][0]:.4f} ms (CUDA "
              f"graph), plain twin {ms[k][1]:.4f} ms, bound "
              f"{BOUND[k][0]:.4f} ms ({BOUND[k][1]}), "
              + ((f"the dense float32 matmul pair {lib:.4f} ms"
                  if k == "rescale_image" else f"F.pad {lib:.4f} ms")
                 if lib else "no PyTorch call computes it") + f" [{card}]",
              flush=True)


def sampled_phase(streams: dict, card: str, ms: dict) -> dict:
    """Phase 15: the sampled decode.  decode_sampled on the four 4K streams
    at each target in each colour config, counted, the twins made to
    raise, each call's launches held to its route; every kernel call of
    those decodes against its twin; the thumbnail route's codes against
    the float64 host thumbnail; M1 for decode_sampled beside api.decode;
    the kernels' timings."""
    t_phase = time.perf_counter()
    current, calls, ac = [], {}, [0]
    watch = SAMPLED_WATCH

    def main_path():
        got, per = {}, {}
        for label, data in streams.items():
            for target, (w, h, mode) in SAMPLED_TARGETS.items():
                for config in sampled_configs(target):
                    current[:] = [label, target, config]
                    before = {k: KERNELS[k]["fn"].launches for k in watch}
                    n_ac = ac[0]
                    got[label, target, config] = api.decode_sampled(
                        data, w, h, config, mode, device="cuda")[0]
                    per[label, target, config] = dict(
                        {k: KERNELS[k]["fn"].launches - before[k]
                         for k in watch}, read_pass_group=ac[0] - n_ac)
        return got, per

    with contextlib.ExitStack() as stack:
        for module, names in SAMPLED_TWINS:
            stack.enter_context(forbidden(module, names))
        stack.enter_context(recorded(calls, current))
        stack.enter_context(counted(PARSE, "read_pass_group", ac))
        t0 = time.perf_counter()
        (got, per), counts = drive("main path (decode_sampled)", main_path,
                                   SAMPLED_KERNELS)
        t_main = time.perf_counter() - t0
    bits = {label: api.basic_info(data).bits_per_sample
            for label, data in streams.items()}
    for (label, target, config), launches in per.items():
        route, want = sampled_expect(label, target)
        out = got[label, target, config]
        if config == sampled_configs(target)[0]:
            print(f"sampled {label} {target}: route {route}, launches "
                  f"{launches}, {out.shape} {out.dtype}", flush=True)
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"sampled {label} {target} config {config}: "
                                 f"launches {launches}, expected {want}")
        w, h, mode = SAMPLED_TARGETS[target]
        packed = PACK.fmt_of(config, bits[label]) in (PACK.RGB565,
                                                       PACK.RGBA1010102)
        if (mode == FILL and out.shape[:2] != (h, w)) or \
                packed != (out.ndim == 2):
            raise AssertionError(f"sampled {label} {target} config {config}: "
                                 f"{out.shape} {out.dtype}")
    print(f"main path: {len(per)} decode_sampled calls in {t_main:.1f} s",
          flush=True)
    check_sampled_kernels(calls)
    check_thumbnails(streams, calls)
    # every target of the 4K d1.0 e7 frame and the PQ stream; the
    # thumbnail alone of the text and the Modular still (their other
    # targets are full decodes, as the PQ stream's)
    thumb = next(iter(SAMPLED_TARGETS))
    layers = {label: sampled_layers(
        label, streams[label], card, 2 if label == "4k_d1.0_e7" else 1,
        list(SAMPLED_TARGETS) if label in ("4k_d1.0_e7", "4k_rgba16_noise_pq")
        else [thumb]) for label in streams}
    sampled_timings(calls, card, ms)
    print(f"phase 15 (the sampled decode) took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(counts, layers=layers)


# ---- phase 16: animation, progressive and truncated decode ---------------

ANIM_KERNELS = ("compose", "legacy_filters_batch")
# what the phase's card path must not run: every plain twin of its path
ANIM_TWINS = SAMPLED_TWINS + (
    (COMPOSE, ("compose_plain",)),
    (FF, ("legacy_filters_batch_plain", "legacy_filters_plain")),
    (LP, LEGACY_PLAIN))
ANIM_WATCH = ANIM_KERNELS + ("synth_family", "synth_dct8",
                             "restore_and_output", "rescale_image")
# the FHD lossy animation: AnimatedEncoder's defaults (quality 90, effort
# 7), a seeded frame moving 24 px a frame
ANIM_FRAMES, ANIM_H, ANIM_W = 6, 1080, 1920
SPRITE_H, SPRITE_W = 240, 320
# the round-1 animation, cut to 256x384: its pure-Python entropy coding
# takes ~20 s for one FHD parse (ROADMAP 2B item 8)
ROUND1_FRAMES, ROUND1_H, ROUND1_W = 8, 256, 384
# the float64 arithmetic of one glibc powf (encode.cuh powf_glibc): the
# log2 polynomial (r, r2, r4, its three pairs and the sum, 15), the
# exponent's scaling and split (xd, kd, rr: 4) and the exp2 polynomial and
# its scale (8)
POWF_F64_OPS = 27
# least fp64 operations per composed value (the BLEND of a colour channel:
# the alpha's division, 1 - fa, two products, the sum, the division by
# the coverage, the rounding and the clip)
COMPOSE_OPS = 12


def compose_case(dtype, dev, params: np.ndarray, h: int = ANIM_H,
                 w: int = ANIM_W):
    """A seeded h x w canvas and frame of params' channels (compose's
    int32 parameters), made on the card, the colour's alpha channel with
    runs of 0 and the largest code; the whole canvas its window."""
    nch, ncolor = int(params[0]), int(params[1])
    maxv = 255 if dtype == torch.uint8 else 65535
    g = torch.Generator(device=dev).manual_seed(21)
    canvas, src = (torch.randint(0, maxv + 1, (h, w, nch), generator=g,
                                 device=dev, dtype=torch.int32)
                   for _ in range(2))
    for k, a in enumerate((canvas, src)):
        a[k::3, ::2, ncolor] = 0
        a[1 + k::4, 1::3, ncolor] = maxv
    return (canvas.to(dtype), src.to(dtype),
            COMPOSE.Window(0, 0, 0, 0, w, h))


def anim_frame_job(k: int) -> bytes:
    """Frame k of the FHD lossy animation, alone (animated_stream's bytes
    are the header's and the frames' one after another)."""
    hdr = animation_header(ANIM_H, ANIM_W, 3, 8, lossless=False)
    img = np.roll(bench_frame(ANIM_H, ANIM_W), 24 * k, axis=1)
    return animation_frame(hdr, img, 100, k == ANIM_FRAMES - 1,
                           lossless=False, quality=90)


def sprite_job() -> bytes:
    return sprite_animation(ANIM_H, ANIM_W, SPRITE_H, SPRITE_W)


def round1_job() -> bytes:
    return legacy_animation([np.roll(bench_frame(ROUND1_H, ROUND1_W),
                                     16 * k, axis=1)
                             for k in range(ROUND1_FRAMES)])


def progressive_job():
    """The 4K d1.0 e7 frame with two passes, its prefixes cut after pass
    0's last group and after HF global, and their float64 oracles."""
    data = reference.encode_vardct(bench_frame(2160, 3840), distance=1.0,
                                   effort=7, progressive=True)
    cs, hdr, fh, toc = api._first_frame(data)
    ng, ndc = fh.counts(hdr)

    def end(i):
        return toc.section(i).offset + toc.section(i).size

    cuts = {"pass0": data[:max(end(2 + ndc + gi) for gi in range(ng))],
            "hf": data[:max(end(i) for i in range(2 + ndc))]}
    return data, cuts, {"preview": reference.preview_float64(data, 1),
                        "hf": reference.dc_upsampled_float64(cuts["hf"])}


def start_anim_jobs(pool) -> dict:
    """Phase 16's jobs, the longest (the 4K two-pass still) first."""
    progressive = pool.apply_async(progressive_job)
    return {"progressive": progressive,
            "sprites": pool.apply_async(sprite_job),
            "round1": pool.apply_async(round1_job),
            "frames": [pool.apply_async(anim_frame_job, (k,))
                       for k in range(ANIM_FRAMES)]}


def frame_rules(data: bytes) -> tuple:
    """Per frame of the index: (get_frame decodes it alone, A10 composes
    it, it is shown), by the reference's rules (animation.py:120-121,
    api.py:1013-1016 and 1029-1033)."""
    img = animation.AnimatedImage(data, "cpu")
    hdr, m = img.image_header, img.image_header.metadata
    rules = []
    for e in img.frames:
        fh = e.header
        regular = fh.frame_type in (0, 3)
        alone = regular and fh.blending_info.mode == 0 and not fh.have_crop
        fw, fhh = fh.frame_width or hdr.xsize, fh.frame_height or hdr.ysize
        composes = regular and (fh.have_crop or fh.blending_info.mode != 0
                                or fw < hdr.xsize or fhh < hdr.ysize) and \
            COMPOSE.window((hdr.ysize, hdr.xsize), (fhh, fw), fh.x0,
                           fh.y0) is not None
        shown = regular and (fh.duration > 0 or m.animation is None
                             or fh.is_last)
        rules.append((alone, composes, shown))
    return rules


def cursor_composes(rules, order) -> int:
    """A10 launches of get_frame over `order` on a fresh AnimatedImage:
    the resumable cursor's walk (animation._compose_to)."""
    nxt, last, n = None, -1, 0
    for i in order:
        if rules[i][0] or (nxt is not None and last == i):
            continue
        if nxt is None or nxt > i:
            nxt = 0
        n += sum(rules[j][1] for j in range(nxt, i + 1))
        nxt, last = i + 1, i
    return n


@contextlib.contextmanager
def recorded_anim(calls: dict, current: list):
    """Record A10's calls (the canvas before and after, the frame, the
    window, the blending) while current names a stream, and the batched
    kernel's calls with the round-1 frames the host read for them."""
    saved = []

    def wrap(owner, name, record):
        orig = getattr(owner, name)

        @functools.wraps(orig)
        def call(*args, **kwargs):
            before = call.launches if hasattr(call, "launches") else 0
            pre = args[0].clone() if name == "compose" and current else None
            out = orig(*args, **kwargs)
            if hasattr(orig, "launches"):
                orig.launches += call.launches - before
            if current:
                record(args, kwargs, out, pre)
            return out
        saved.append((owner, name, orig))
        setattr(owner, name, call)

    wrap(COMPOSE, "compose", lambda a, k, o, pre: calls["compose"].append(
        (current[0], pre, a[1], a[2], a[3], a[0].clone())))
    wrap(FF, "legacy_filters_batch",
         lambda a, k, o, pre: calls["batch"].append((a, k, o)))
    wrap(codec, "read_vardct_still",
         lambda a, k, o, pre: calls["read"].append((a, o)))
    try:
        yield
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


ANIM_LAYERS = {
    "host half (parse, Modular channels)": ("_host_one",),
    "device half (h2d, kernels; synchronised)": ("_frame_device", "_xyb"),
    "compose (A10, the canvas copy)": ("_compose_frame", "_canvas"),
    "d2h": ("_to_host",),
}


@contextlib.contextmanager
def split_anim(log: list):
    """Wrap the functions get_frame calls (the device steps synchronise in
    their wrappers); restore them on exit."""
    saved = []
    device = ("_frame_device", "_xyb", "_compose_frame", "_canvas")
    for names in ANIM_LAYERS.values():
        for name in names:
            owner = animation if name == "_to_host" else api
            saved.append((owner, name, owner.__dict__[name]))
            setattr(owner, name, tspan(getattr(owner, name), name, log,
                                       sync=name in device))
    try:
        yield
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


def anim_layers(label: str, data: bytes, order, card: str,
                runs: int = 2) -> dict:
    """M1 for get_frame over `order`, each pass on a fresh AnimatedImage:
    `runs` split passes in turns with as many unsplit ones (split first in
    even pairs); raises if a split pass's layers do not sum to within 2%
    of its own total.  -> ms per frame by layer (medians of the split
    passes) and the unsplit passes' median total."""
    med = statistics.median
    split, unsplit = [], []
    for i in range(2 * runs):
        img = animation.AnimatedImage(data, "cuda")
        log = []
        torch.cuda.synchronize()
        is_split = (i % 2 == 0) == (i // 2 % 2 == 0)
        with no_gc(), split_anim(log) if is_split else \
                contextlib.nullcontext():
            t0 = time.perf_counter()
            for k in order:
                img.get_frame(k)
            total = (time.perf_counter() - t0) * 1e3
        if is_split:
            own, _other = exclusive_ms(log)
            split.append((total, {k: sum(own.get(n, 0.0) for n in names)
                                  for k, names in ANIM_LAYERS.items()}))
        else:
            unsplit.append(total)
    gaps = [abs(sum(per.values()) - total) / total for total, per in split]
    if max(gaps) > 0.02:
        raise AssertionError(f"get_frame {label}: a split pass's layers sum "
                             f"to {max(gaps):.2%} off its own total")
    n = len(order)
    per = {k: med(p[k] for _, p in split) / n for k in ANIM_LAYERS}
    t_split, t_unsplit = med(t for t, _ in split) / n, med(unsplit) / n
    print(f"layers get_frame {label} {n} frames {list(order)[:6]}... (host "
          f"clock, ms per frame, median of {runs} split passes): "
          + ", ".join(f"{k} {v:.3f}" for k, v in per.items())
          + f"; each pass's layers summed within {max(gaps):.2%} of its own "
          f"total; split passes {t_split:.2f}, unsplit passes {t_unsplit:.2f}"
          f" (split - unsplit {t_split - t_unsplit:+.2f}: the wrappers' cost "
          f"and the spread) [{card}]", flush=True)
    return dict(per, split=t_split, total=t_unsplit)


def anim_timings(calls: dict, streams: dict, prog, cuts, card: str,
                 ms: dict) -> dict:
    """decode_frames' frames per second at FHD; the 4K preview and
    truncated decodes against decode in the same turns; A10 and the
    batched kernel 6 by CUDA graph against twin and bound."""
    med = statistics.median
    times = {}
    for label, data in streams.items():
        n = len(api.decode_frames(data, device="cuda")[0])
        t = []
        for _ in range(2):
            t0 = time.perf_counter()
            api.decode_frames(data, device="cuda")
            t.append(time.perf_counter() - t0)
        times[label] = n / med(t)
        print(f"decode_frames {label}: {n} shown frames, "
              f"{times[label]:.2f} frames/s ({med(t) * 1e3:.1f} ms a call, "
              f"median of 2) [{card}]", flush=True)
    runs = {"decode": lambda: api.decode(prog, device="cuda"),
            "decode_preview(passes=1)": lambda: api.decode_preview(
                prog, 1, device="cuda"),
            "decode of the cut after pass 0": lambda: api.decode(
                cuts["pass0"], device="cuda"),
            "decode of the cut after HF global": lambda: api.decode(
                cuts["hf"], device="cuda")}
    t = {k: [] for k in runs}
    for turn in range(2):
        for k in (list(runs) if turn % 2 == 0 else list(runs)[::-1]):
            torch.cuda.synchronize()
            with no_gc():
                t0 = time.perf_counter()
                runs[k]()
                t[k].append((time.perf_counter() - t0) * 1e3)
    print("4k progressive (host clock, ms, median of 2 in turns): "
          + ", ".join(f"{k} {med(v):.1f}" for k, v in t.items())
          + f" [{card}]", flush=True)
    times["4k"] = {k: med(v) for k, v in t.items()}
    # A10 at its largest main-path call: the whole-canvas BLEND frame
    _label, pre, src, win, params, _post = max(
        calls["compose"], key=lambda c: c[3].cw * c[3].ch)
    canvas = pre.clone()
    nch = src.shape[2]
    vals = win.cw * win.ch * nch
    note_bound("compose", 3 * vals * src.element_size(),
               vals * COMPOSE_OPS, F64_OPS_PER_S, "fp64")
    ms["compose"] = (
        graph_ms(lambda: COMPOSE.compose(canvas, src, win, params)),
        device_ms(lambda: COMPOSE.compose_plain(canvas, src, win, params)))
    print(f"kernel compose (A10) at {win.cw}x{win.ch}x{nch} {src.dtype}: "
          f"device {ms['compose'][0]:.4f} ms (CUDA graph), plain twin "
          f"{ms['compose'][1]:.4f} ms, bound {BOUND['compose'][0]:.4f} ms "
          f"({BOUND['compose'][1]}), no PyTorch call computes it [{card}]",
          flush=True)
    # the same blending at 16 bits: a seeded canvas of the same size
    canvas16, src16, win16 = compose_case(torch.uint16, src.device, params,
                                          win.ch, win.cw)
    got, want = canvas16.clone(), canvas16.clone()
    COMPOSE.compose(got, src16, win16, params)
    COMPOSE.compose_plain(want, src16, win16, params)
    bad = int((got.to(torch.int32) != want.to(torch.int32)).sum())
    if bad:
        raise AssertionError(f"A10 u16: {bad} codes differ from its twin")
    t16 = (graph_ms(lambda: COMPOSE.compose(canvas16, src16, win16, params)),
           device_ms(lambda: COMPOSE.compose_plain(canvas16, src16, win16,
                                                   params)))
    b16 = bound_of(3 * vals * 2, vals * COMPOSE_OPS, F64_OPS_PER_S)
    print(f"kernel compose (A10) at {win.cw}x{win.ch}x{nch} torch.uint16 "
          f"(a seeded canvas of the same blending): device {t16[0]:.4f} ms "
          f"(CUDA graph), plain twin {t16[1]:.4f} ms, bound {b16[0]:.4f} ms "
          f"({b16[1]}), 0 codes differ from the twin [{card}]", flush=True)
    args, kw, out = calls["batch"][0]
    imgs, qfs = args[0], args[1]
    px = imgs.shape[0] * imgs.shape[2] * imgs.shape[3]
    note_bound("legacy_filters_batch", nbytes(imgs, qfs, out),
               px * (OPS_PX["gaborish"] + OPS_PX["epf2"] + OPS_PX["codes"]))
    ms["legacy_filters_batch"] = (
        graph_ms(lambda: FF.legacy_filters_batch(*args, **kw)),
        device_ms(lambda: FF.legacy_filters_batch_plain(*args, **kw)))
    singles = graph_ms(lambda: [FF.legacy_filters(imgs[k], qfs[k],
                                                  *args[2:], "u8")
                                for k in range(imgs.shape[0])], n=10)
    print(f"kernel legacy_filters_batch (kernel 6, {imgs.shape[0]} frames "
          f"of {imgs.shape[2]}x{imgs.shape[3]}): device "
          f"{ms['legacy_filters_batch'][0]:.4f} ms (CUDA graph), "
          f"{imgs.shape[0]} single launches {singles:.4f} ms, plain twin "
          f"{ms['legacy_filters_batch'][1]:.4f} ms, bound "
          f"{BOUND['legacy_filters_batch'][0]:.4f} ms "
          f"({BOUND['legacy_filters_batch'][1]}) [{card}]", flush=True)
    return times


def anim_phase(jobs: dict, card: str, ms: dict) -> dict:
    """Phase 16: the animated, progressive and truncated decode.  Counted
    with every plain twin made to raise: decode_frames, get_frame in order
    and at (0, 3, 2, 5, last) and api.decode on the FHD lossy and sprite
    animations, decode_frames_batch on the round-1 animation,
    decode_preview on both entropy routes and the two cuts of the 4K
    progressive still; each call's launches held to its route; the
    outputs against the float64 oracles; A10's and the batched kernel's
    calls against their twins; M1 for get_frame; timings."""
    t_phase = time.perf_counter()
    hdr = animation_header(ANIM_H, ANIM_W, 3, 8, lossless=False)
    streams = {"fhd_lossy": header_bytes(hdr) + b"".join(
        j.get() for j in jobs["frames"]), "fhd_sprites": jobs["sprites"].get()}
    round1 = jobs["round1"].get()
    prog, cuts, oracles = jobs["progressive"].get()
    rules = {k: frame_rules(d) for k, d in streams.items()}
    # the animations' float64 oracles on host threads while the card runs
    host = ThreadPoolExecutor(2)
    refs = {k: host.submit(reference.frames_float64, d)
            for k, d in streams.items()}
    calls = {"compose": [], "batch": [], "read": []}
    current, ac, watch = [], [0], ANIM_WATCH
    order = {k: [0, 3, 2, 5, len(r) - 1] for k, r in rules.items()}
    dev = api.resolve_device("cuda")

    def main_path():
        got, per = {}, {}

        def run(key, fn):
            before = {k: KERNELS[k]["fn"].launches for k in watch}
            n_ac = ac[0]
            got[key] = fn()
            per[key] = dict({k: KERNELS[k]["fn"].launches - before[k]
                             for k in watch}, read_pass_group=ac[0] - n_ac)

        for label, data in streams.items():
            current[:] = [label]
            run((label, "decode_frames"),
                lambda: api.decode_frames(data, device="cuda"))
            current[:] = []
            img = animation.AnimatedImage(data, "cuda")
            run((label, "get_frame in order"),
                lambda: [img.get_frame(i) for i in range(img.frames_count)])
            img = animation.AnimatedImage(data, "cuda")
            run((label, "get_frame at random"),
                lambda: [img.get_frame(i) for i in order[label]])
            run((label, "decode"), lambda: api.decode(data, device="cuda"))
        current[:] = ["round1"]
        rimg = animation.AnimatedImage(round1, "cuda")
        run(("round1", "decode_frames_batch"),
            lambda: animation.decode_frames_batch(rimg))
        current[:] = []
        for ent in ("host", "device"):
            run(("4k", f"preview {ent}"), lambda: api.decode_preview(
                prog, 1, device="cuda", entropy=ent))
        run(("4k", "cut after pass 0"),
            lambda: api.decode(cuts["pass0"], device="cuda"))
        run(("4k", "cut after HF global"),
            lambda: api.decode(cuts["hf"], device="cuda"))
        run(("4k", "DC render"),
            lambda: api._decode_partial(cuts["hf"], dev, "host"))
        return got, per, rimg

    with contextlib.ExitStack() as stack:
        for module, names in ANIM_TWINS:
            stack.enter_context(forbidden(module, names))
        stack.enter_context(recorded_anim(calls, current))
        stack.enter_context(counted(PARSE, "read_pass_group", ac))
        t0 = time.perf_counter()
        (got, per, rimg), counts = drive(
            "main path (animation, preview, truncated)", main_path,
            ANIM_KERNELS)
        t_main = time.perf_counter() - t0
    print(f"main path: {len(per)} calls in {t_main:.1f} s", flush=True)
    # each call's launches
    for key, launches in per.items():
        label, what = key
        want = {}
        if label in streams:
            r = rules[label]
            n = len(r)
            want["compose"] = {
                "decode_frames": sum(c for _, c, _ in r),
                "get_frame in order": cursor_composes(r, range(n)),
                "get_frame at random": cursor_composes(r, order[label]),
                "decode": cursor_composes(r, [n - 1])}[what]
            want["legacy_filters_batch"] = 0
        elif label == "round1":
            want = {"legacy_filters_batch": 1, "compose": 0}
        else:
            want = {"compose": 0, "legacy_filters_batch": 0}
            if what == "DC render":
                want.update(synth_family=0, synth_dct8=0, read_pass_group=0,
                            restore_and_output=1, rescale_image=1)
        print(f"{label} {what}: launches {launches}", flush=True)
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"{label} {what}: launches {launches}, "
                                 f"expected {want}")
    # the animations against the float64 oracles; get_frame against
    # decode_frames
    for label in streams:
        frames, durations, _info = got[label, "decode_frames"]
        ref_frames, ref_durations = refs[label].result()
        if durations != ref_durations or len(frames) != len(ref_frames):
            raise AssertionError(f"{label}: durations {durations} vs the "
                                 f"oracle's {ref_durations}")
        for k, (a, b) in enumerate(zip(frames, ref_frames)):
            if label == "fhd_lossy":
                within_one_code(a, b, f"{label} frame {k} vs the float64 "
                                      f"host decoder")
            elif not np.array_equal(a, b):
                raise AssertionError(f"{label} frame {k} differs from the "
                                     f"host frames composed by A10's twin")
        shown = [i for i, (_a, _c, s) in enumerate(rules[label]) if s]
        in_order = got[label, "get_frame in order"]
        for k, i in enumerate(shown):
            if not np.array_equal(in_order[i], frames[k]):
                raise AssertionError(f"{label}: get_frame({i}) differs "
                                     f"from decode_frames' frame {k}")
        for i, a in zip(order[label], got[label, "get_frame at random"]):
            if not np.array_equal(a, in_order[i]):
                raise AssertionError(f"{label}: get_frame({i}) at random "
                                     f"differs from in order")
        if not np.array_equal(got[label, "decode"][0], frames[-1]):
            raise AssertionError(f"{label}: decode is not the last frame")
        print(f"animation {label}: {len(frames)} shown frames equal to the "
              f"oracle{' within 1 code' if label == 'fhd_lossy' else ''}"
              f"; get_frame in order and at {order[label]} equal to "
              f"decode_frames; decode is the last frame", flush=True)
    host.shutdown()
    # A10 against its twin on every composed frame
    worst = 0
    for label, pre, src, win, params, post_ in calls["compose"]:
        twin = pre.clone()
        COMPOSE.compose_plain(twin, src, win, params)
        worst = max(worst, (twin.int() - post_.int()).abs().max().item())
    note_err("compose", worst, 0, f"{len(calls['compose'])} composed frames "
             f"of decode_frames")
    # the batched kernel 6 against N single launches and its twin; the
    # batch against the round-1 codec's decode of each frame
    (args, kw, out), = calls["batch"]
    imgs, qfs = args[0], args[1]
    singles = torch.stack([FF.legacy_filters(imgs[k], qfs[k], *args[2:],
                                             "u8")
                           for k in range(imgs.shape[0])])
    if not torch.equal(out, singles):
        raise AssertionError("batched kernel 6 differs from single launches")
    twin = FF.legacy_filters_batch_plain(*args, **kw)
    note_err("legacy_filters_batch",
             (twin.int() - out.int()).abs().max().item(), 0,
             f"{imgs.shape[0]} frames of {imgs.shape[2]}x{imgs.shape[3]}, "
             f"equal to {imgs.shape[0]} single launches")
    batch = got["round1", "decode_frames_batch"]
    for k, ((rargs, data), e) in enumerate(zip(calls["read"], rimg.frames)):
        one = codec.reconstruct_vardct_still(data, rimg.image_header,
                                             e.header, dev)
        if not np.array_equal(batch[k], one):
            raise AssertionError(f"round-1 frame {k}: the batch differs "
                                 f"from the codec's decode")
    print(f"decode_frames_batch: {batch.shape} equal to the round-1 codec's "
          f"per-frame decodes", flush=True)
    # the progressive still
    a, b = got["4k", "preview host"][0], got["4k", "preview device"][0]
    if not np.array_equal(a, b):
        raise AssertionError("decode_preview: the entropy routes differ")
    within_one_code(a, oracles["preview"], "4k decode_preview(passes=1) vs "
                                           "the float64 host preview")
    within_one_code(got["4k", "cut after pass 0"][0], oracles["preview"],
                    "4k cut after pass 0 vs the float64 host preview")
    within_one_code(got["4k", "cut after HF global"][0], oracles["hf"],
                    "4k cut after HF global vs the float64 DC upsample")
    if not np.array_equal(got["4k", "DC render"][0],
                          got["4k", "cut after HF global"][0]):
        raise AssertionError("the DC render differs from decode's")
    # M1 in order (get_frame at random is held to decode_frames above)
    layers = {label: {"in order": anim_layers(label, data,
                                              range(len(rules[label])), card)}
              for label, data in streams.items()}
    times = anim_timings(calls, streams, prog, cuts, card, ms)
    print(f"phase 16 (animation, progressive and truncated) took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(counts, layers=layers, times=times,
                round1=(batch, [d for _, d in calls["read"]]))


# ---- phase 17: the JPEG routes ----------------------------------------------

JPEG_KERNELS = ("jpeg_idct", "ycbcr_to_rgb", "encode_output_ycbcr")
# label: (height, width, port_fixtures.baseline_jpeg's options, route): route
# 1 a 4:4:4 or grey recompressed JPEG (a VarDCT frame), 2 a subsampled one
# (J1, J2), 3 the round-1 container (host.jpeg.transcode.construct; J1, J2)
JPEG_STREAMS = {
    "4k_420": (2160, 3840, dict(quality=90, subsampling=2), 2),
    "4k_444": (2160, 3840, dict(quality=90, subsampling=0), 1),
    "fhd_422": (1080, 1920, dict(quality=90, subsampling=1), 2),
    "fhd_420": (1080, 1920, dict(quality=90, subsampling=2), 2),
    "ragged_420": (667, 1001, dict(quality=85, subsampling=2), 2),
    "grey": (480, 720, dict(quality=90, grey=True), 1),
    "restart_420": (480, 640, dict(quality=80, subsampling=2, restart=8), 2),
    "round1_420": (480, 640, dict(quality=90, subsampling=2), 3),
}
# what a JPEG decode on the card must not run: the kernels' plain twins
JPEG_TWINS = SAMPLED_TWINS + (
    (JPX, ("jpeg_idct_plain", "ycbcr_to_rgb_plain")),
    (synth, ("synth_family_plain",)))
# M1's layers of a JPEG api.decode: layer -> the functions it wraps (the
# device steps synchronise in their wrappers)
JPEG_LAYERS = {
    "host read": ("host_half",),
    "upload": ("upload", "from_prepared"),
    "J1": ("jpeg_idct",),
    "J2": ("ycbcr_to_rgb",),
    "device half (rest)": ("device_half",),
    "d2h": ("d2h",),
    "rest": ("jpeg_info", "basic_info", "apply_orientation"),
}


def jpeg_job(label: str) -> dict:
    """In a worker process: the JPEG (port_fixtures.baseline_jpeg on
    bench_frame), its recompression by the port (api.construct, or the
    round-1 container's writer), the round trip through reconstruct_jpeg,
    and the float64 oracle of its decode (the host decoder on route 1,
    reference.jpeg_pixels_float64 on routes 2 and 3) and of a 4:4:4
    stream's thumbnail."""
    torch.set_num_threads(1)
    h, w, opts, route = JPEG_STREAMS[label]
    t0 = time.perf_counter()
    jpeg = baseline_jpeg(bench_frame(h, w), **opts)
    t1 = time.perf_counter()
    data = (JTC.construct(jpeg) if route == 3 else api.construct(jpeg))
    t2 = time.perf_counter()
    back = api.reconstruct_jpeg(data)
    t3 = time.perf_counter()
    ref = (reference.decode_float64(data) if route == 1
           else reference.jpeg_pixels_float64(data))
    t4 = time.perf_counter()
    thumb = reference.thumbnail_float64(data) if route == 1 else None
    return dict(jpeg=jpeg, data=data, same=back == jpeg, ref=ref, thumb=thumb,
                s=(t1 - t0, t2 - t1, t3 - t2, time.perf_counter() - t3))


def start_jpeg_jobs(pool) -> dict:
    return {label: pool.apply_async(jpeg_job, (label,))
            for label in JPEG_STREAMS}


def jpeg_seeded(dev) -> None:
    """J1, J2 and A7's "ycbcr" case against their twins on seeded inputs:
    block grids from 1x1 to ragged, one to four components; every shift
    pair of the triangle mode and nearest factors to 4, grey, from 1x1
    up; the YCbCr output at 8 and 16 bits, and pooled (S1)."""
    rng = np.random.default_rng(17)
    for grids in ([(1, 1)], [(3, 5), (2, 3), (2, 3)],
                  [(7, 2), (7, 1), (4, 1), (9, 9)], [(1, 9), (1, 5), (1, 5)]):
        coeffs = []
        for bh, bw in grids:
            c = rng.integers(-80, 80, (bh, bw, 64))
            c[:, :, 0] = rng.integers(-1024, 1024, (bh, bw))
            coeffs.append(c)
        coef = torch.from_numpy(np.concatenate(
            [c.reshape(-1) for c in coeffs]).astype(np.int16)).to(dev)
        quant = torch.from_numpy(rng.integers(1, 256, (len(grids), 64))
                                 .astype(np.float32)).to(dev)
        got = JPX.jpeg_idct(coef, grids, quant)
        ref = JPX.jpeg_idct_plain(coef, grids, quant)
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        note_err("jpeg_idct", err, 0, f"seeded grids {grids}")
    worst, n = 0, 0
    for triangle, rounded in ((True, True), (False, False)):
        sets = ([[(1, 1)] * 3, [(1, 1), (2, 2), (2, 2)],
                 [(1, 1), (1, 2), (1, 2)], [(1, 1), (2, 1), (2, 1)],
                 [(2, 2), (1, 1), (1, 1)], [(1, 1)]]
                + ([] if triangle else [[(1, 1), (1, 4), (1, 4)],
                                        [(2, 2)] * 3]))
        for factors in sets:
            for h, w in ((1, 1), (2, 3), (9, 13), (67, 101)):
                planes = [torch.from_numpy(
                    (rng.random((-(-h // fy), -(-w // fx))) * 320 - 30)
                    .astype(np.float32)).to(dev) for fy, fx in factors]
                got = JPX.ycbcr_to_rgb(planes, factors, h, w, triangle,
                                       rounded)
                ref = JPX.ycbcr_to_rgb_plain(planes, factors, h, w, triangle,
                                             rounded)
                worst = max(worst, int((got.int() - ref.int()).abs().max()))
                n += 1
    note_err("ycbcr_to_rgb", worst, 0, f"{n} seeded cases (triangle + 0.5 "
             f"and nearest, every shift pair, grey, 1x1 to 67x101)")
    xyb = torch.from_numpy(((rng.random((3, 67, 101)) - 0.5) * [[[0.9]],
                                                                [[1.1]],
                                                                [[0.9]]])
                           .astype(np.float32)).to(dev)
    worst = 0
    for bits in (8, 16):
        got = post.encode_output(xyb, ("ycbcr",), bits)
        ref = post.encode_output_plain(xyb, ("ycbcr",), bits)
        worst = max(worst, int((got.int() - ref.int()).abs().max()))
        got = post.encode_output_down(xyb, ("ycbcr",), bits, 4)
        ref = post.encode_output_down_plain(xyb, ("ycbcr",), bits, 4)
        worst = max(worst, int((got.int() - ref.int()).abs().max()))
    note_err("encode_output_ycbcr", worst, 0, "seeded 67x101 planes, 8 and "
             "16 bits, and pooled by 4 (S1)")


@contextlib.contextmanager
def jpeg_recorded(calls: dict, current: list):
    """Record each J1, J2 and A7 call of the JPEG main path per stream
    (current[0]): its arguments, A7's spec and planes cloned (its input is
    freed after the call)."""
    saved = []

    def wrap(owner, name, keep):
        orig = getattr(owner, name)

        @functools.wraps(orig)
        def call(*args, **kwargs):
            before = call.launches
            out = orig(*args, **kwargs)
            # the count orig adds through its module's name: hand it back
            orig.launches += call.launches - before
            calls.setdefault((name, current[0]), []).append(
                (keep(args), out))
            return out
        saved.append((owner, name, orig))
        setattr(owner, name, call)

    wrap(JPX, "jpeg_idct", lambda a: a)
    wrap(JPX, "ycbcr_to_rgb", lambda a: a)
    wrap(post, "encode_output", lambda a: (a[0].clone(), a[1], a[2]))
    try:
        yield
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


@contextlib.contextmanager
def split_jpeg(log: list):
    """Wrap the functions of JPEG_LAYERS for one api.decode call (the
    device steps synchronised); the device half's pixels log their d2h."""
    saved = []
    sync = {"upload", "from_prepared", "jpeg_idct", "ycbcr_to_rgb"}
    for names in JPEG_LAYERS.values():
        for name in names:
            if name in ("d2h", "device_half"):
                continue
            owner = JPX if name in ("upload", "jpeg_idct",
                                    "ycbcr_to_rgb") else api
            saved.append((owner, name, owner.__dict__[name]))
            setattr(owner, name, tspan(getattr(owner, name), name, log,
                                       sync=name in sync))
    device_half = api.device_half

    def device(*args, **kwargs):
        t0 = time.perf_counter()
        px = device_half(*args, **kwargs)
        torch.cuda.synchronize()
        log.append(("device_half", t0, time.perf_counter(),
                    threading.get_ident()))
        return PixelsT(px, log)
    saved.append((api, "device_half", device_half))
    api.device_half = device
    try:
        yield
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


def jpeg_layers(label: str, data: bytes, card: str, runs: int = 2) -> dict:
    """M1 for api.decode of one JPEG stream: `runs` split calls in turns
    with as many unwrapped ones; raises if a split call's layers do not
    sum to within 2% of its own total.  -> ms by layer (medians) and the
    unsplit calls' median."""
    med = statistics.median
    split, unsplit = [], []
    for i in range(2 * runs):
        log = []
        torch.cuda.synchronize()
        is_split = (i % 2 == 0) == (i // 2 % 2 == 0)
        with no_gc(), split_jpeg(log) if is_split else \
                contextlib.nullcontext():
            t0 = time.perf_counter()
            api.decode(data, device="cuda")
            total = (time.perf_counter() - t0) * 1e3
        if is_split:
            own, _other = exclusive_ms(log)
            split.append((total, {k: sum(own.get(n, 0.0) for n in names)
                                  for k, names in JPEG_LAYERS.items()}))
        else:
            unsplit.append(total)
    gaps = [abs(sum(per.values()) - total) / total for total, per in split]
    if max(gaps) > 0.02:
        raise AssertionError(f"decode {label}: a split call's layers sum to "
                             f"{max(gaps):.2%} off its own total")
    per = {k: med(p[k] for _, p in split) for k in JPEG_LAYERS}
    h, w = JPEG_STREAMS[label][:2]
    t_unsplit = med(unsplit)
    print(f"layers jpeg {label} {w}x{h} (host clock, ms, median of {runs} "
          f"split api.decode calls): "
          + ", ".join(f"{k} {v:.1f}" for k, v in per.items())
          + f"; each call's layers summed within {max(gaps):.2%} of its own "
          f"total; split calls {med(t for t, _ in split):.1f}, unsplit calls "
          f"{t_unsplit:.1f} = {h * w / 1e3 / t_unsplit:.2f} MP/s [{card}]",
          flush=True)
    return dict(per, total=t_unsplit)


def jpeg_timings(calls: dict, card: str, ms: dict) -> None:
    """J1 and J2 on the 4K 4:2:0 stream's main-path inputs and A7 "ycbcr"
    on the 4K 4:4:4 stream's, each by CUDA graph against its twin, its
    bound and, for J1, the fp32 matmul pair (TF32 off) on the same
    dequantised blocks."""
    (coef, grids, quant), planes = calls["jpeg_idct", "4k_420"][0]
    nsamp = sum(bh * bw * 64 for bh, bw in grids)
    # each coefficient read (int16) and each sample written (f32) once; 16
    # multiply-adds a sample (8 per pass)
    note_bound("jpeg_idct", nbytes(coef) + 4 * nsamp, 32 * nsamp)
    ms["jpeg_idct"] = (graph_ms(lambda: JPX.jpeg_idct(coef, grids, quant)),
                       device_ms(lambda: JPX.jpeg_idct_plain(coef, grids,
                                                             quant)))
    m8 = torch.from_numpy(dct_matrix(8)).to(coef.device)
    zz = torch.from_numpy(np.asarray(ZIGZAG, np.int64)).to(coef.device)
    blocks, off = [], 0
    for c, (bh, bw) in enumerate(grids):
        deq = coef[off:off + bh * bw * 64].view(bh, bw, 64).float() * \
            quant[c]
        off += bh * bw * 64
        b = torch.empty_like(deq)
        b[:, :, zz] = deq
        blocks.append(b.view(bh, bw, 8, 8))
    mt = m8.t().contiguous()
    LIBRARY_MS["jpeg_idct"] = graph_ms(
        lambda: [torch.matmul(torch.matmul(mt, b), m8) for b in blocks])
    print(f"kernel jpeg_idct at 4k 4:2:0 ({nsamp / 1e6:.1f} M samples, 3 "
          f"components, one launch): {ms['jpeg_idct'][0]:.4f} ms (CUDA "
          f"graph), plain twin {ms['jpeg_idct'][1]:.3f} ms, bound "
          f"{BOUND['jpeg_idct'][0]:.4f} ms, the fp32 matmul pair (TF32 off) "
          f"{LIBRARY_MS['jpeg_idct']:.4f} ms [{card}]", flush=True)

    (planes, factors, h, w, tri, rnd), out = calls["ycbcr_to_rgb",
                                                   "4k_420"][0]
    # per pixel: two chroma samples of up to 3 operations an upsampled
    # axis, the offsets, 4 products and 4 sums, 3 x (+0.5, 2 clamps): ~30
    note_bound("ycbcr_to_rgb", nbytes(*planes) + nbytes(out), 30 * h * w)
    ms["ycbcr_to_rgb"] = (
        graph_ms(lambda: JPX.ycbcr_to_rgb(planes, factors, h, w, tri, rnd)),
        device_ms(lambda: JPX.ycbcr_to_rgb_plain(planes, factors, h, w, tri,
                                                 rnd)))
    print(f"kernel ycbcr_to_rgb at 4k 4:2:0 (triangle, +0.5): "
          f"{ms['ycbcr_to_rgb'][0]:.4f} ms (CUDA graph), plain twin "
          f"{ms['ycbcr_to_rgb'][1]:.3f} ms, bound "
          f"{BOUND['ycbcr_to_rgb'][0]:.4f} ms [{card}]", flush=True)

    (xyb, spec, bits), out = calls["encode_output", "4k_444"][0]
    # per pixel: the Y offset, 4 products and 4 sums, 3 x (scale, +0.5,
    # floor, 2 clamps): 24
    note_bound("encode_output_ycbcr", nbytes(xyb) + nbytes(out),
               xyb[0].numel() * 24)
    ms["encode_output_ycbcr"] = (
        graph_ms(lambda: post.encode_output(xyb, spec, bits)),
        device_ms(lambda: post.encode_output_plain(xyb, spec, bits)))
    print(f"kernel encode_output (ycbcr) at 4k 4:4:4: "
          f"{ms['encode_output_ycbcr'][0]:.4f} ms (CUDA graph), plain twin "
          f"{ms['encode_output_ycbcr'][1]:.3f} ms, bound "
          f"{BOUND['encode_output_ycbcr'][0]:.4f} ms [{card}]", flush=True)


def jpeg_phase(jobs: dict, still: bytes, card: str, ms: dict) -> dict:
    """Phase 17: the JPEG routes.  The streams' round trips; J1, J2 and A7
    "ycbcr" against their twins on seeded inputs; api.decode on every
    stream, counted, the twins made to raise, each frame's launches held
    to its route and its pixels to the float64 oracle; the kernels
    against their twins on the main path's 4K inputs; M1 for the 4K 4:4:4
    and the FHD 4:2:0 decode; decode_batch, decode_thumbnail and
    decode_sampled; the kernels' timings."""
    t_phase = time.perf_counter()
    streams = {}
    for label, job in jobs.items():
        r = job.get()
        h, w, _opts, route = JPEG_STREAMS[label]
        print(f"jpeg {label} {w}x{h} route {route}: {len(r['jpeg'])} B JPEG "
              f"-> {len(r['data'])} B JXL; reconstruct_jpeg byte for byte "
              f"{'equal' if r['same'] else 'DIFFERENT'} (worker: JPEG "
              f"{r['s'][0]:.1f} s, construct {r['s'][1]:.1f} s, reconstruct "
              f"{r['s'][2]:.1f} s, float64 oracle {r['s'][3]:.1f} s)",
              flush=True)
        if not r["same"]:
            raise AssertionError(f"jpeg {label}: construct -> "
                                 f"reconstruct_jpeg is not the JPEG")
        streams[label] = r
    dev = torch.device("cuda")
    jpeg_seeded(dev)

    current, calls = [None], {}
    watch = JPEG_KERNELS[:2] + ("synth_family", "synth_dct8",
                                "restore_and_output", "encode_output")

    def main_path():
        outs, per = {}, {}
        for label, r in streams.items():
            current[0] = label
            before = {k: KERNELS[k]["fn"].launches for k in watch}
            outs[label] = api.decode(r["data"], device="cuda")[0]
            per[label] = {k: KERNELS[k]["fn"].launches - before[k]
                          for k in watch}
        return outs, per

    with contextlib.ExitStack() as stack:
        for module, names in JPEG_TWINS:
            stack.enter_context(forbidden(module, names))
        stack.enter_context(jpeg_recorded(calls, current))
        t0 = time.perf_counter()
        (outs, per), counts = drive("main path (api.decode, JPEG routes)",
                                    main_path, JPEG_KERNELS)
        t_main = time.perf_counter() - t0
    specs = {spec for (name, _l), v in calls.items()
             if name == "encode_output" for (_x, spec, _b), _o in v}
    if specs != {("ycbcr",)}:
        raise AssertionError(f"the JPEG main path ran A7 with {specs}")
    for label, launches in per.items():
        route = JPEG_STREAMS[label][3]
        want = ({"jpeg_idct": 0, "ycbcr_to_rgb": 0, "synth_dct8": 1,
                 "synth_family": 0, "restore_and_output": 1,
                 "encode_output": 1} if route == 1 else
                {"jpeg_idct": 1, "ycbcr_to_rgb": 1, "synth_dct8": 0,
                 "synth_family": 0, "restore_and_output": 0,
                 "encode_output": 0})
        print(f"frame jpeg {label} (route {route}) launches: {launches}",
              flush=True)
        if launches != want:
            raise AssertionError(f"jpeg {label}: launches {launches}, "
                                 f"expected {want}")
        within_one_code(outs[label], streams[label]["ref"],
                        f"decode jpeg {label} vs its float64 oracle")
    print(f"main path: {len(per)} JPEG decodes in {t_main:.1f} s", flush=True)

    # the kernels against their twins on the main path's inputs
    for label in ("4k_420", "round1_420", "ragged_420"):
        (coef, grids, quant), got = calls["jpeg_idct", label][0]
        ref = JPX.jpeg_idct_plain(coef, grids, quant)
        note_err("jpeg_idct", max(float((a - b).abs().max())
                                  for a, b in zip(got, ref)), 0,
                 f"the main path's {label} input")
        (planes, factors, h, w, tri, rnd), got = calls["ycbcr_to_rgb",
                                                      label][0]
        ref = JPX.ycbcr_to_rgb_plain(planes, factors, h, w, tri, rnd)
        note_err("ycbcr_to_rgb", int((got.int() - ref.int()).abs().max()), 0,
                 f"the main path's {label} input")
    for label in ("4k_444", "grey"):
        (xyb, spec, bits), got = calls["encode_output", label][0]
        ref = post.encode_output_plain(xyb, spec, bits)
        note_err("encode_output_ycbcr",
                 int((got.int() - ref.int()).abs().max()), 0,
                 f"the main path's {label} planes")

    # the other entry points: a mixed batch, the thumbnail, decode_sampled
    batch = ["4k_444", "fhd_422", "ragged_420", "grey", "restart_420",
             "round1_420"]
    rgba = int(api.PreferredColorConfig.RGBA_8888)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for module, names in JPEG_TWINS:
            stack.enter_context(forbidden(module, names))
        got = api.decode_batch([streams[k]["data"] for k in batch] + [still],
                               "cuda")
        t_batch = time.perf_counter() - t0
        still_px = api.decode(still, "cuda")[0]
        other = {}
        # the 4:2:0 route at FHD: at 4K its two full host reads took 27 s
        for label in ("4k_444", "fhd_420"):
            t0 = time.perf_counter()
            thumb = api.decode_thumbnail(streams[label]["data"], "cuda")[0]
            t1 = time.perf_counter()
            sampled = api.decode_sampled(streams[label]["data"], 960, 540,
                                         rgba, device="cuda")[0]
            other[label] = (thumb, sampled, t1 - t0, time.perf_counter() - t1)
    for label, out in zip(batch, got):
        if not np.array_equal(out, outs[label]):
            raise AssertionError(f"decode_batch: {label} differs from "
                                 f"api.decode's output")
    if not np.array_equal(got[-1], still_px):
        raise AssertionError("decode_batch: the still differs")
    print(f"decode_batch of {batch} and the FHD d4.0 still: each equal to "
          f"api.decode's ({t_batch:.1f} s)", flush=True)
    for label, (thumb, sampled, t_thumb, t_sampled) in other.items():
        print(f"jpeg {label}: decode_thumbnail {thumb.shape} in "
              f"{t_thumb:.1f} s, decode_sampled 960x540 RGBA_8888 "
              f"{sampled.shape} in {t_sampled:.1f} s", flush=True)
        if sampled.shape != (540, 960, 4) or (sampled[:, :, 3] != 255).any():
            raise AssertionError(f"sampled jpeg {label}: {sampled.shape}, "
                                 f"alpha not opaque")
        px = torch.from_numpy(outs[label])
        if label == "4k_444":
            # the DC image through A7 "ycbcr"; the quarter route, S1's pool
            within_one_code(thumb, streams[label]["thumb"],
                            f"thumbnail jpeg {label} (the DC image, A7 ycbcr)"
                            f" vs the float64 host thumbnail")
            ref = streams[label]["ref"].astype(np.float64).reshape(
                540, 4, 960, 4, 3).mean(axis=(1, 3))
            d = np.abs(sampled[:, :, :3].astype(np.float64) - ref)
            print(f"sampled jpeg {label} (S1 ycbcr) against the 4x4 box of "
                  f"the float64 oracle's pixels: max {d.max():.2f}, share "
                  f"beyond 2 codes {(d > 2).mean():.3g}", flush=True)
            if (d > 2).mean() >= 1e-3:
                raise AssertionError(f"sampled jpeg {label}: beyond 2 codes "
                                     f"of the box on 0.1% of values")
        else:
            # R12's route: a full decode, then S2; the quarter route is
            # ineligible: a full decode, then S3
            box = SAMPLE.box_codes_plain(px).numpy()
            if not np.array_equal(thumb, box):
                raise AssertionError(f"thumbnail {label}: not the 8x box of "
                                     f"its decode")
            scaled = RESIZE.rescale_image_plain(
                px, 960, 540, FIT, int(api.ResizeFilter.MITCHELL)).numpy()
            d = np.abs(sampled[:, :, :3].astype(int) - scaled)
            print(f"thumbnail jpeg {label}: S2's 8x box of its decode (equal "
                  f"to the twin's); decode_sampled against S3's twin on "
                  f"api.decode's pixels: max {d.max()} code", flush=True)
            if d.max() > 1:
                raise AssertionError(f"sampled jpeg {label}: not S3 of its "
                                     f"decode")

    layers = {label: jpeg_layers(label, streams[label]["data"], card)
              for label in ("4k_444", "fhd_420")}
    jpeg_timings(calls, card, ms)
    print(f"phase 17 (the JPEG routes) took {time.perf_counter() - t_phase:.1f}"
          f" s", flush=True)
    return dict(counts, layers=layers)


# ---------------------------------------------------------------------------
# 18. The encoders: api.encode (lossy VarDCT with the encoder front E1-E4 on
# the card, lossless Modular), AnimatedEncoder

ENC_KERNELS = ("enc_front_planes", "enc_front_blocks", "enc_dct_costs",
               "enc_special_costs", "enc_gather_rows")
ENC_FNS = dict(zip(ENC_KERNELS, ("front_planes", "front_blocks", "dct_costs",
                                 "special_costs", "gather_rows")))
# what the card's route must not run: the twins and the float64 host front
ENC_TWINS = ((EK, tuple(f"{n}_plain" for n in ENC_FNS.values())),
             (ENCR, ("encoded_to_xyb", "_gaborish_sharpen", "_masking_field",
                     "_estimate_cfl", "_select_strategies")))
ENC_TIE_SHARE = 1e-5   # quantised values that differ, all at ties
# relative, on varblocks whose values agree: a cost's distortion sums
# squares of (reconstruction - coefficient), which cancel where the step is
# small against the coefficient, so the coefficients' 1e-7 from the sums'
# order grows there (1.57e-5 seen on the sharp strokes' 32x16 shape)
ENC_COST_TOL = 1e-4
ENC_CO_TOL = 2e-6      # of the coefficients' largest magnitude
ENC_MASK_TOL = 1e-5    # the masking field, in [1, 4]
ENC_CFL_TOL = 1e-5     # of each tile sum's largest magnitude (or 1e-9)
ENC_PSNR_TOL = 0.1     # dB, tests/test_enc_device.py's criterion
ENC_SIZE_TOL = 0.02
ENC_ANIM_FRAMES = 4
# the 4K lossless still is cut to FHD: the host encoder's effort-7 ladder
# (RCT search, learned trees) took 46.3 s at FHD in a worker on the card's
# host, ~4x that at 4K (PERF.md section 4)
ENC_LOSSLESS_H, ENC_LOSSLESS_W = 1080, 1920


def enc_text_plan_job():
    """The 4K text frame's patch plan (the detector, host code)."""
    from jxl_coder_tpu_torch.host.vardct import enc_patches
    t0 = time.perf_counter()
    plan = enc_patches.detect(text_frame(2160, 3840))
    return plan, time.perf_counter() - t0


def enc_lossless_job():
    """The FHD lossless still at effort 7 (host code) and its time."""
    img = bench_frame(ENC_LOSSLESS_H, ENC_LOSSLESS_W)
    t0 = time.perf_counter()
    data = api.encode(img, lossless=True, effort=7, device="cpu")
    return data, time.perf_counter() - t0


def start_enc_jobs(pool) -> dict:
    return {"text_plan": pool.apply_async(enc_text_plan_job),
            "lossless": pool.apply_async(enc_lossless_job)}


@contextlib.contextmanager
def enc_recorded(calls: list):
    """Record each E1-E4 and gather call: (name, args, result, the cost it
    wrote), the arguments as they were (nothing is updated in place but
    the cost slice, cloned after the call)."""
    saved = []

    def wrap(name):
        orig = getattr(EK, name)

        @functools.wraps(orig)
        def call(*args, **kwargs):
            before = call.launches
            out = orig(*args, **kwargs)
            orig.launches += call.launches - before
            cost = args[-1].clone() if name in ("dct_costs",
                                               "special_costs") else None
            calls.append((name, args, out, cost))
            return out
        saved.append((name, orig))
        setattr(EK, name, call)

    for name in ENC_FNS.values():
        wrap(name)
    try:
        yield
    finally:
        for name, orig in reversed(saved):
            setattr(EK, name, orig)


def enc_check_quant(kernel: str, got, cost, ref, ref_cost, ratios, what,
                    elig=None, block_dep: bool = False) -> tuple:
    """E3 / E4 against the twin: values equal but at ties (EK.tie_faults:
    a decision that moves when its ratio moves by 1e-5 relative; an X / B
    value whose Y at the same coefficient, or for E4 anywhere in its
    block, flipped at a tie); the costs within ENC_COST_TOL where the
    values agree.  Returns (share of values that differ, the largest
    relative cost error)."""
    diff = got != ref
    if elig is not None:
        diff &= elig[..., None, None]
    bad = EK.tie_faults(diff, ratios, ENCR.AC_DEADZONE, block_dep)
    share = float(diff.float().mean())
    if bad.any() or share > ENC_TIE_SHARE:
        raise AssertionError(f"{kernel} {what}: {int(diff.sum())} values "
                             f"differ (share {share:.3g}), {int(bad.sum())} "
                             f"of them not at a tie")
    rows = ~diff.flatten(2).any(-1).reshape(-1)
    big = ref_cost >= 1e29
    if not torch.equal(big, cost >= 1e29):
        raise AssertionError(f"{kernel} {what}: the ineligible blocks differ")
    keep = rows & ~big
    rel = float(((cost - ref_cost).abs() / ref_cost.abs().clamp_min(1e-30))
                [keep].max()) if keep.any() else 0.0
    note_err(kernel, rel, ENC_COST_TOL,
             f"{what} (relative cost; {share:.3g} of values differ, at ties)")
    return share, rel


def enc_check_call(call, what: str) -> None:
    """One recorded E call against its twin on the same inputs."""
    name, args, out, cost = call
    if name == "front_planes":
        ref = EK.front_planes_plain(*args)
        note_err("enc_front_planes", float((out - ref).abs().max()), 0, what)
    elif name == "front_blocks":
        co, small = out
        rco, rsmall = EK.front_blocks_plain(*args)
        _, ph, pw = args[0].shape
        nb = (ph // 8) * (pw // 8)
        nt = (-(-ph // 64)) * (-(-pw // 64))
        scale = float(rco.abs().max())
        note_err("enc_front_blocks", float((co - rco).abs().max()),
                 ENC_CO_TOL * scale, f"{what} co")
        for part, sl, tol in (
                ("mask", slice(0, nb), ENC_MASK_TOL),
                ("dc", slice(nb + 3 * nt, None), ENC_CO_TOL * scale)):
            d = float((small[sl] - rsmall[sl]).abs().max())
            print(f"parity enc_front_blocks {what} {part}: {d:.3g} (tol "
                  f"{tol:.3g})", flush=True)
            if not d <= tol:
                raise AssertionError(f"enc_front_blocks {what} {part}: {d}")
        for k in range(3):
            sl = slice(nb + k * nt, nb + (k + 1) * nt)
            d = float((small[sl] - rsmall[sl]).abs().max())
            m = float(rsmall[sl].abs().max())
            # the host takes no CfL factor below y2 = 1e-9
            if not d <= max(ENC_CFL_TOL * m, 1e-9):
                raise AssertionError(f"enc_front_blocks {what} CfL sum {k}: "
                                     f"{d} of {m}")
    elif name == "dct_costs":
        ref_cost = torch.empty_like(cost)
        ref, ratios = EK.dct_costs_plain(*args[:-1], ref_cost,
                                         return_ratios=True)
        enc_check_quant("enc_dct_costs", out, cost, ref, ref_cost, ratios,
                        f"{what} sid {args[7]} {args[8]}x{args[9]}")
    elif name == "special_costs":
        ref_cost = torch.empty_like(cost)
        ref, ratios = EK.special_costs_plain(*args[:-1], ref_cost,
                                             return_ratios=True)
        enc_check_quant("enc_special_costs", out, cost, ref, ref_cost, ratios,
                        f"{what} sid {args[8]}", elig=args[7],
                        block_dep=True)
        refuses_unaligned(
            "enc_special_costs", lambda planes: EK.special_costs(
                planes, *args[1:-1], torch.empty_like(cost)), args[0])
    else:
        ref = EK.gather_rows_plain(*args)
        note_err("enc_gather_rows", float((out.int() - ref.int()).abs().max())
                 if out.numel() else 0.0, 0, what)


def enc_seeded(dev) -> None:
    """E1-E4 and the gather against their twins on seeded inputs: 1x1 to a
    ragged 4K crop (2150x3830: partial tiles of every kernel), every
    candidate shape that fits, every special transform on a seeded
    eligibility mask, u8 / u16 / float samples, gaborish on and off."""
    rng = np.random.default_rng(18)
    for size in ((1, 1), (40, 56), (136, 200), (2150, 3830)):
        img = bench_frame(*size)
        h, w, _ = img.shape
        ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
        pad = np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
        kinds = [("u8", pad, 4)]
        if h == 40:
            kinds += [("u16", (pad.astype(np.uint16) * 257).view(np.int16), 4),
                      ("f32", pad.astype(np.float32) / 255.0, 0)]
        for kind, arr, gab in kinds:
            pix = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
            calls = []
            with enc_recorded(calls):
                planes = EK.front_planes(pix, gab)
                co, _small = EK.front_blocks(planes)
            for call in calls:
                enc_check_call(call, f"seeded {w}x{h} {kind} gab {gab}")
        ys_b, xs_b = ph // 8, pw // 8
        qf = torch.from_numpy(rng.integers(2, 16, (ys_b, xs_b)).astype(
            np.int32)).to(dev)
        fx, fb = (torch.from_numpy(rng.normal(0, 0.1, (ys_b, xs_b)).astype(
            np.float32)).to(dev) for _ in range(2))
        dq = co[:, :, :, 0, 0].contiguous()
        elig = torch.from_numpy(rng.random((ys_b, xs_b)) < 0.5).to(dev)
        calls = []
        with enc_recorded(calls):
            srcs = []
            for sid, cy, cx in [(0, 1, 1)] + ENCR._EFFORT_CANDS["full"]:
                if ys_b // cy and xs_b // cx:
                    cost = torch.empty((ys_b // cy) * (xs_b // cx),
                                       device=dev)
                    srcs.append(EK.dct_costs(co if sid == 0 else planes, qf,
                                             fx, fb, dq, 10.92, 0.05, sid,
                                             cy, cx, ENCR.AC_DEADZONE, cost))
            for sid in ENCR._SPECIAL_CANDS:
                cost = torch.empty(ys_b * xs_b, device=dev)
                srcs.append(EK.special_costs(planes, qf, fx, fb, dq, 10.92,
                                             0.05, elig, sid,
                                             ENCR.AC_DEADZONE, cost))
            idxs = [torch.from_numpy(rng.integers(
                -2, s.shape[0] * s.shape[1] + 2, 37).astype(np.int32)).to(dev)
                for s in srcs]
            EK.gather_rows(srcs, idxs)
        for call in calls:
            enc_check_call(call, f"seeded {w}x{h}")
    torch.cuda.synchronize()


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(peak ** 2 / max(mse, 1e-12)))


def enc_same_point(label: str, ours: bytes, ref: bytes, img: np.ndarray,
                   what: str, peak: float = 255.0) -> tuple:
    """tests/test_enc_device.py's criterion: size within 2% (or 64 B) and
    the decoded PSNR within 0.1 dB, both decoded on the card."""
    a = api.decode(ours, "cuda")[0]
    b = api.decode(ref, "cuda")[0]
    src = img[..., :a.shape[-1]] if a.ndim == 3 else img
    pa, pb = psnr(a, src, peak), psnr(b, src, peak)
    print(f"encode {label}: {len(ours)} B against {what} {len(ref)} B "
          f"({(len(ours) - len(ref)) / len(ref):+.4%}), bytes "
          f"{'equal' if ours == ref else 'differ'}; PSNR {pa:.4f} / "
          f"{pb:.4f} dB", flush=True)
    if abs(len(ours) - len(ref)) > max(64, ENC_SIZE_TOL * len(ref)) or \
            abs(pa - pb) >= ENC_PSNR_TOL:
        raise AssertionError(f"encode {label}: not at {what}'s RD point")
    return a, pa, pb


ENC_LAYERS = ("prelude", "front dispatch", "small d2h",
              "host quant field / DC", "costs + DC substreams", "greedy",
              "gather + d2h", "tokens + assembly")


@contextlib.contextmanager
def enc_split(log: dict):
    """Time the layers of one lossy api.encode: Front's calls (the front
    dispatch synchronised), _greedy_decide and the patch detector (a
    thread of its own) logged by name; the rest by difference."""
    saved = []

    def wrap(owner, name, sync=False):
        orig = getattr(owner, name)

        @functools.wraps(orig)
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            log.setdefault(name, []).append((t0, time.perf_counter()))
            return out
        saved.append((owner, name, orig))
        setattr(owner, name, call)

    wrap(ENCDEV.Front, "run_front_dispatch", sync=True)
    for name in ("run_front_fetch", "run_costs_dispatch", "run_costs_fetch",
                 "fetch_selected_dispatch", "fetch_selected_fetch"):
        wrap(ENCDEV.Front, name)
    wrap(ENCR, "_greedy_decide")
    wrap(EPAT, "detect")
    try:
        yield
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


def enc_layers(img: np.ndarray, card: str, host_s=None, runs: int = 2
               ) -> dict:
    """M1 for the 4K lossy encode: `runs` unsplit and `runs` split calls
    in turns (unsplit first); each split call's layers from its own
    timestamps.  Beside them, the float64 host route on the same frame:
    phase 3's encode of it (host_s, seconds; the workers at nice 10 beside
    it), or one call here when phase 3 read it from the cache."""
    unsplit, split = [], []
    for i in range(2 * runs):
        gc.collect()
        t0 = time.perf_counter()
        if i % 2 == 0:
            api.encode(img, lossless=False, quality=90, effort=7,
                       device="cuda")
            unsplit.append(time.perf_counter() - t0)
            continue
        log = {}
        with enc_split(log):
            t0 = time.perf_counter()
            api.encode(img, lossless=False, quality=90, effort=7,
                       device="cuda")
            total = time.perf_counter() - t0
        (f0, f1), = log["run_front_dispatch"]
        (g0, g1), = log["run_front_fetch"]
        (c0, _), = log["run_costs_dispatch"]
        (_, c1), = log["run_costs_fetch"]
        (r0, r1), = log["_greedy_decide"]
        (s0, s1), = log["fetch_selected_dispatch"]
        (h0, h1), = log["fetch_selected_fetch"]
        lay = {"prelude": f0 - t0, "front dispatch": f1 - f0,
               "small d2h": g1 - g0, "host quant field / DC": c0 - g1,
               "costs + DC substreams": c1 - c0, "greedy": r1 - r0,
               "gather + d2h": (s1 - s0) + (h1 - h0)}
        lay["tokens + assembly"] = total - sum(lay.values())
        det = [b - a for a, b in log.get("detect", [])]
        split.append((total, lay, det))
    t_un = statistics.median(unsplit)
    t_sp = statistics.median(s[0] for s in split)
    med = {k: statistics.median(s[1][k] for s in split) for k in ENC_LAYERS}
    det = [d for s in split for d in s[2]]
    print(f"layers 4k encode (d1.0 e7, the card's front; M1, medians of "
          f"{runs} split calls, in turns with {runs} unsplit): total "
          f"{t_un * 1e3:.1f} ms unsplit, {t_sp * 1e3:.1f} ms split; " +
          ", ".join(f"{k} {v * 1e3:.1f}" for k, v in med.items()) +
          (f"; the patch detector's thread {statistics.median(det) * 1e3:.1f}"
           f" ms" if det else "") + f" [{card}]", flush=True)
    if abs(t_sp - t_un) > 0.1 * t_un:
        print(f"  (split and unsplit totals differ by "
              f"{(t_sp - t_un) / t_un:+.1%})", flush=True)
    where = "phase 3's encode of the same frame"
    if host_s is None:
        gc.collect()
        t0 = time.perf_counter()
        ENCR.encode_vardct_real(img, distance=1.0, effort=7)
        host_s = time.perf_counter() - t0
        where = "one call on the same frame, here"
    t_host = host_s
    print(f"encode 4k d1.0 e7 by the float64 host route ({where}): "
          f"{t_host * 1e3:.1f} ms; the card's route {t_host / t_un:.2f}x "
          f"faster [{card}]", flush=True)
    return dict(unsplit=t_un, split=t_sp, layers=med, host=t_host)


def special_products_ms(args) -> float:
    """The products of special_costs_plain (enc_kernels.py), two a
    channel, by fp32 torch.matmul (TF32 off) on one call's eligible
    blocks, by CUDA graph: the transforms alone, no quantiser."""
    planes, elig, sid = args[0], args[7], args[8]
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the yardstick runs with TF32 off")
    ys_b, xs_b = elig.shape
    _r0, R1, A = EK._tables(planes.device, ("special", sid))
    blocks = planes.reshape(3, ys_b, 8, xs_b, 8).permute(1, 3, 0, 2, 4) \
        .reshape(ys_b * xs_b, 3, 64)[elig.reshape(-1)].contiguous()
    coef = torch.ones((blocks.shape[0], 63), device=planes.device)
    return graph_ms(lambda: [(torch.matmul(blocks[:, c], A[c]),
                              torch.matmul(coef, R1[c])) for c in range(3)])


def enc_timings(main_calls: list, special_calls: list, card: str,
                ms: dict) -> None:
    """Each kernel at the 4K main path's shapes (E4 at the 4K text's, the
    main path's own when it ran there): CUDA graph against the twin (CUDA
    events; fp.div's host scalars keep it out of a graph), the bound and
    the yardstick (the fp32 torch.matmul pair of the transforms, TF32 off;
    index_select for the gather)."""
    first = {}
    for c in main_calls:
        first.setdefault(c[0], c)
    pix, gab = first["front_planes"][1]
    planes = first["front_blocks"][1][0]
    px = planes.shape[1] * planes.shape[2]
    # four sharpen steps: the stencil of three planes (OPS_PX counts all
    # three) and err -= g, out += err per plane; the XYB 40 f32 a pixel;
    # and at least the three cbrt powf a pixel in float64 steps
    note_bound("enc_front_planes", nbytes(pix) + 12 * px,
               px * (OPS_PX["gaborish"] + 3 * 2) * 4 + px * 40,
               also=(px * 3 * POWF_F64_OPS, F64_OPS_PER_S, "fp64"))
    ms["enc_front_planes"] = (graph_ms(lambda: EK.front_planes(pix, gab)),
                              device_ms(lambda: EK.front_planes_plain(pix,
                                                                      gab)))
    co, small = first["front_blocks"][2]
    note_bound("enc_front_blocks", nbytes(planes, co, small),
               px * (3 * 32 + 64 + 12))
    ana = EK._tables(planes.device, "ana8")
    ys_b, xs_b = planes.shape[1] // 8, planes.shape[2] // 8
    b8 = planes.reshape(3, ys_b, 8, xs_b, 8).permute(0, 1, 3, 2, 4)
    ms["enc_front_blocks"] = (graph_ms(lambda: EK.front_blocks(planes)),
                              device_ms(lambda: EK.front_blocks_plain(planes)))
    LIBRARY_MS["enc_front_blocks"] = graph_ms(
        lambda: torch.matmul(torch.matmul(ana, b8), ana.t()))
    # E3: the main path's seven launches, summed
    k_ms = p_ms = lib = moved = ops = 0.0
    for name, args, out, _cost in main_calls:
        if name != "dct_costs":
            continue
        sid, cy, cx = args[7:10]
        cost = torch.empty_like(args[-1])
        a = args[:-1] + (cost,)
        t = graph_ms(lambda: EK.dct_costs(*a))
        tp = device_ms(lambda: EK.dct_costs_plain(*a))
        h, w = 8 * cy, 8 * cx
        n = out.shape[0] * out.shape[1]
        moved += nbytes(out, cost, args[1], args[2], args[3], args[4]) + \
            (nbytes(args[0]) if sid == 0 else n * 3 * h * w * 4)
        ops += n * 3 * h * w * ((0 if sid == 0 else 2 * (h + w)) + 60)
        tl = None
        if sid:
            st = EK._tables(planes.device, ("shape", sid, cy, cx))
            reg = planes[:, :out.shape[0] * h, :out.shape[1] * w].reshape(
                3, out.shape[0], h, out.shape[1], w).permute(1, 3, 0, 2, 4)
            tl = graph_ms(lambda: torch.matmul(
                torch.matmul(st["anaH"], reg), st["anaW"].t()))
            lib += tl
        k_ms += t
        p_ms += tp
        print(f"kernel enc_dct_costs sid {sid} {cy}x{cx} at 4k: {t:.4f} ms, "
              f"plain {tp:.3f} ms" + (f", the matmul pair {tl:.4f} ms"
                                      if tl is not None else "") +
              f" [{card}]", flush=True)
    note_bound("enc_dct_costs", int(moved), ops)
    ms["enc_dct_costs"] = (k_ms, p_ms)
    LIBRARY_MS["enc_dct_costs"] = lib
    print(f"kernel enc_dct_costs at 4k: the seven shapes {k_ms:.4f} ms "
          f"against the six shapes' matmul pairs {lib:.4f} ms (the "
          f"transforms alone) [{card}]", flush=True)
    # E4: the five launches of one frame, summed
    k_ms = p_ms = moved = ops = 0.0
    label = None
    LIBRARY_MS["enc_special_costs"] = 0.0
    for name, args, out, _cost in special_calls:
        if name != "special_costs":
            continue
        label = f"{args[0].shape[2]}x{args[0].shape[1]}"
        cost = torch.empty_like(args[-1])
        a = args[:-1] + (cost,)
        n_el = int(args[7].sum())
        k_ms += graph_ms(lambda: EK.special_costs(*a))
        p_ms += device_ms(lambda: EK.special_costs_plain(*a))
        moved += nbytes(out, cost, args[1], args[2], args[3], args[4],
                        args[7]) + n_el * 3 * 64 * 4
        ops += n_el * 3 * (2 * 64 * 63 * 2 + 63 * 40)
        LIBRARY_MS["enc_special_costs"] += special_products_ms(a)
    note_bound("enc_special_costs", int(moved), ops)
    ms["enc_special_costs"] = (k_ms, p_ms)
    print(f"kernel enc_special_costs (5 transforms) at {label}: "
          f"{k_ms:.4f} ms, plain {p_ms:.3f} ms; the twin's fp32 "
          f"torch.matmul products on the eligible blocks (the transforms "
          f"alone) {LIBRARY_MS['enc_special_costs']:.4f} ms [{card}]",
          flush=True)
    ptxas_report("encode", only="special_costs_kernel")
    srcs, idxs = first["gather_rows"][1]
    flat = first["gather_rows"][2]
    note_bound("enc_gather_rows", 2 * nbytes(flat) + nbytes(*idxs), 0)
    ms["enc_gather_rows"] = (graph_ms(lambda: EK.gather_rows(srcs, idxs)),
                             device_ms(lambda: EK.gather_rows_plain(srcs,
                                                                    idxs)))
    rows = [s.reshape(-1, s.shape[2] * s.shape[3]) for s in srcs]
    LIBRARY_MS["enc_gather_rows"] = graph_ms(lambda: [
        r.index_select(0, i) for r, i in zip(rows, idxs)])
    for k in ENC_KERNELS:
        lib_ms = LIBRARY_MS[k]
        print(f"kernel {k} at 4k: {ms[k][0]:.4f} ms, plain {ms[k][1]:.3f} "
              f"ms, bound {BOUND[k][0]:.4f} ms ({BOUND[k][1]}), yardstick "
              + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none") +
              f" [{card}]", flush=True)


def enc_phase(jobs: dict, streams: dict, text: bytes, anim_frames: list,
              card: str, ms: dict) -> dict:
    """Phase 18: the encoders.  E1-E4 and the gather against their twins on
    seeded inputs; the main path (the 4K d1.0 e7 lossy encode and the
    517x771 sharp strokes), counted, the twins and the float64 host front
    made to raise, each E call against its twin, each stream at the host
    route's RD point and decoded within the decode contract; the 4K text
    (patches), the 720x480 16-bit, RGBA, noise and progressive encodes
    against the CPU route; the FHD lossless still's round trip; four FHD
    lossy frames through AnimatedEncoder and decode_frames; M1; timings."""
    t_phase = time.perf_counter()
    dev = api.resolve_device("cuda")
    enc_seeded(dev)
    img4k = bench_frame(2160, 3840)
    sharp = sharp_frame(517, 771)
    calls, per = [], {}

    def main_path():
        out = {}
        for label, img in (("4k", img4k), ("sharp", sharp)):
            before = {k: KERNELS[k]["fn"].launches for k in ENC_KERNELS}
            t0 = time.perf_counter()
            out[label] = api.encode(img, lossless=False, quality=90,
                                    effort=7, device="cuda")
            print(f"encode {label} on the card: {len(out[label])} B in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            per[label] = {k: KERNELS[k]["fn"].launches - before[k]
                          for k in ENC_KERNELS}
        return out

    with contextlib.ExitStack() as stack:
        for module, names in ENC_TWINS:
            stack.enter_context(forbidden(module, names))
        stack.enter_context(enc_recorded(calls))
        outs, counts = drive("main path (api.encode, lossy)", main_path,
                             ENC_KERNELS)
    host = ThreadPoolExecutor(2)
    f64 = {k: host.submit(reference.decode_float64, d)
           for k, d in outs.items()}
    for label, img in (("4k", img4k), ("sharp", sharp)):
        h, w, _ = img.shape
        ys_b, xs_b = -(-h // 8), -(-w // 8)
        specials = ENCR._special_eligibility(np.pad(img, (
            (0, ys_b * 8 - h), (0, xs_b * 8 - w), (0, 0)), mode="edge"),
            ys_b, xs_b).any()
        want = {"enc_front_planes": 1, "enc_front_blocks": 1,
                "enc_dct_costs": 7, "enc_special_costs": 5 * int(specials),
                "enc_gather_rows": 1}
        print(f"encode {label} launches: {per[label]}", flush=True)
        if per[label] != want:
            raise AssertionError(f"encode {label}: launches {per[label]}, "
                                 f"expected {want}")
    n4k = sum(per["4k"].values())
    for i, call in enumerate(calls):
        enc_check_call(call, "the main path's 4k" if i < n4k
                       else "the main path's sharp 517x771")
    dec = {}
    for label, img, ref in (("4k", img4k, streams["4k_d1.0_e7"][2]),
                            ("sharp", sharp, streams["sharp_d1.0_e7"][2])):
        dec[label] = enc_same_point(label + " d1.0 e7", outs[label], ref,
                                    img, "the float64 host route's stream")
    # the patch path: the 4K text's plan from the pool, the main frame's
    # front on the card
    plan, t_plan = jobs["text_plan"].get()
    text_img = text_frame(2160, 3840)
    text_calls = []
    with contextlib.ExitStack() as stack:
        for module, names in ENC_TWINS:
            stack.enter_context(forbidden(module, names))
        stack.enter_context(enc_recorded(text_calls))
        before = EK.special_costs.launches
        t0 = time.perf_counter()
        text_ours = ENCR._encode_with_patches(text_img, plan, distance=1.0,
                                              effort=7,
                                              front=ENCDEV.Front("cuda"))
        t_text = time.perf_counter() - t0
        n_sp = EK.special_costs.launches - before
    print(f"encode 4k text with patches (detector {t_plan:.1f} s in a "
          f"worker): {t_text:.2f} s on the card's route, E4 launches {n_sp}",
          flush=True)
    if n_sp not in (0, 5):
        raise AssertionError(f"4k text: {n_sp} special launches")
    for call in text_calls:
        if call[0] in ("special_costs", "gather_rows"):
            enc_check_call(call, "the 4k text")
    dec["text"] = enc_same_point("4k text d1.0 e7 (patches)", text_ours, text,
                                 text_img, "the host route's stream")
    # the 720x480 variants against the CPU route (the twins)
    base = bench_frame(480, 720)
    variants = {"16bit": (base.astype(np.uint16) * 257, {}),
                "rgba": (rgba8_frame(480, 720), {}),
                "noise": (base, dict(photon_noise_iso=3200)),
                "progressive": (base, dict(progressive=True))}
    for label, (img, kw) in variants.items():
        ours = api.encode(img, lossless=False, device="cuda", **kw)
        cpu = api.encode(img, lossless=False, device="cpu", **kw)
        peak = 65535.0 if img.dtype == np.uint16 else 255.0
        a, _, _ = enc_same_point(f"720x480 {label}", ours, cpu, img,
                                 "the CPU route's stream", peak)
        if label == "rgba" and not np.array_equal(a[..., 3], img[..., 3]):
            raise AssertionError("rgba: the alpha is not lossless")
    # the lossless still (host code), its round trip on the card
    ll, t_ll = jobs["lossless"].get()
    back = api.decode(ll, "cuda")[0]
    if not np.array_equal(back, bench_frame(ENC_LOSSLESS_H, ENC_LOSSLESS_W)):
        raise AssertionError("the lossless still does not round-trip")
    print(f"encode lossless {ENC_LOSSLESS_W}x{ENC_LOSSLESS_H} e7: {len(ll)} B "
          f"in {t_ll:.1f} s (host code, a worker); decoded on the card equal",
          flush=True)
    # AnimatedEncoder: four FHD lossy frames, the front on the card
    frames = [np.roll(bench_frame(ANIM_H, ANIM_W), 24 * k, axis=1)
              for k in range(ENC_ANIM_FRAMES)]
    t0 = time.perf_counter()
    enc = animation.AnimatedEncoder(ANIM_W, ANIM_H, lossless=False,
                                    quality=90, device="cuda")
    for f in frames:
        enc.add_frame(f, 100)
    anim = enc.encode()
    t_anim = time.perf_counter() - t0
    got, durs, _ = api.decode_frames(anim, "cuda")
    f64["anim"] = host.submit(reference.frames_float64, anim)
    host_len = sum(len(anim_frames[k]) for k in range(ENC_ANIM_FRAMES))
    print(f"AnimatedEncoder: {ENC_ANIM_FRAMES} FHD lossy frames {len(anim)} B "
          f"in {t_anim:.2f} s (the host route's frames {host_len} B, "
          f"{(len(anim) - host_len) / host_len:+.3%}); decode_frames "
          f"{len(got)} frames, durations {list(durs)}; PSNR " +
          ", ".join(f"{psnr(g, f):.3f}" for g, f in zip(got, frames)),
          flush=True)
    if len(got) != ENC_ANIM_FRAMES or \
            abs(len(anim) - host_len) > ENC_SIZE_TOL * host_len:
        raise AssertionError("AnimatedEncoder: frames or size off")
    # the decode contract against the float64 host decoder
    for label in ("4k", "sharp"):
        within_one_code(dec[label][0], f64[label].result(),
                        f"decode of the card's {label} encode vs float64")
    ref_frames = f64["anim"].result()[0]
    for k, (g, r) in enumerate(zip(got, ref_frames)):
        within_one_code(g, r, f"AnimatedEncoder frame {k} vs float64")
    host.shutdown()
    layers = enc_layers(img4k, card, ENCODE_S.get(
        (2160, 3840, "d1.0 e7 bits16 False progressive False")))
    # E4 at 4K: the main path's own launches, else the 4K text's, else the
    # sharp frame's
    special = (calls[:n4k] if per["4k"]["enc_special_costs"] else
               text_calls if n_sp else calls[n4k:])
    enc_timings(calls[:n4k], special, card, ms)
    print(f"phase 18 (the encoders) took {time.perf_counter() - t_phase:.1f}"
          f" s", flush=True)
    return dict(counts, layers=layers)


# ---- 19. the ICC step and any channel count --------------------------------

ICC_TWINS = ((ICC, ("transform_plain", "clut_transform_plain")),)
# the 4K Modular still's embedded profile: Display P3 (para type 3), v4
ICC_P3 = "p3 v4"
# the table profile of the CLUT program's main path: a v4 lutAtoB (A
# curves, a 9 x 11 x 13 CLUT at 16 bits, M curves, matrix + offset, B
# curves) on the XYZ PCS
ICC_LUT = "mab16 xyz v4"
# the CLUT variants' profiles (u16, grey, RGBA, 1x1, ragged)
ICC_LUT_VARIANTS = ("mab16 xyz v4", "black v2")
ICC_H, ICC_W = 2160, 3840     # phase 11's 4k_rct still, the bench frame
# phase 19's channel streams: an FHD Modular still of RGB and 3 extra
# channels, and a sprite animation of RGB and 10 extra channels, cut to
# 540x960 (120x160 sprites): its pure-Python lossless encode grows with
# the pixels, ~4x longer at FHD (PERF.md section 4 has the times)
CH6_H, CH6_W, CH6_N = 1080, 1920, 6
CH13_H, CH13_W, CH13_SH, CH13_SW, CH13_EXTRA = 540, 960, 120, 160, 10
# least operations per pixel of the ICC step: 3 x (3 multiply-adds, the
# rounding add and shift, the clamp's two compares) = 24 int32
ICC_OPS = 24
# and of the CLUT program: the tetrahedron's 3 compares and its two
# corners' and the fractions' selects (6), then per channel 3 differences,
# 3 multiply-adds, the rounding (add, shift, add, shift, add) and
# FROM_16_TO_8 (multiply-add, shift): 3 + 6 + 3 x 16 = 57 int32
CLUT_OPS = 57


def many_channel_frame(h: int, w: int, nch: int, seed: int = 19
                       ) -> np.ndarray:
    """bench_frame's RGB, an alpha with runs of 0 and 255, then smooth
    seeded channels (gradients with 2 bits of noise)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.empty((h, w, nch), np.uint8)
    img[..., :3] = bench_frame(h, w)
    alpha = np.full((h, w), 200, np.int64)
    alpha[(x // 64 + y // 48) % 3 == 0] = 0
    alpha[(x // 40 + y // 56) % 5 == 1] = 255
    img[..., 3] = alpha
    for k in range(4, nch):
        img[..., k] = ((x * (k - 2) + y * 3) // 5 + rng.integers(
            0, 4, (h, w))) % 256
    return img


def ch6_job():
    img = many_channel_frame(CH6_H, CH6_W, CH6_N)
    t0 = time.perf_counter()
    return modular_still(img), time.perf_counter() - t0


def ch13_job():
    t0 = time.perf_counter()
    data = sprite_animation(CH13_H, CH13_W, CH13_SH, CH13_SW, seed=19,
                            n_extra=CH13_EXTRA)
    return data, time.perf_counter() - t0


def start_icc_jobs(pool) -> dict:
    """Phase 19's two streams, the last jobs of phase 3's pool: no worker
    of their own takes the host's cores from the timed phases."""
    return {"ch6": pool.apply_async(ch6_job),
            "ch13": pool.apply_async(ch13_job)}


def icc_cube(dev) -> torch.Tensor:
    """Every 8-bit RGB value once: (4096, 4096, 3) uint8 on `dev`."""
    x = torch.arange(256, dtype=torch.uint8, device=dev)
    return torch.stack(torch.meshgrid(x, x, x, indexing="ij"),
                       -1).reshape(4096, 4096, 3)


def ragged(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return img[:h, :w].contiguous()


def check_icc_seeded(profiles: dict, luts: dict, dev) -> None:
    """The ICC kernels against their twins on the card: the 2^24 cube for
    every test profile and every lookup-table / black-point profile (the
    matrix kernel for those littlecms keeps on its matrix program, the
    CLUT kernel for the rest); u16 RGBA (low bytes and alpha seeded), grey
    and RGBA u8 variants of the cube, a 1x1 and a ragged image for three
    matrix and two CLUT profiles; the float64 model on the cube for one.
    The programs are integers only: nothing can tie, so each kernel equals
    its twin exactly."""
    cube = icc_cube(dev)
    rng = torch.Generator(device=dev).manual_seed(19)
    low = torch.randint(0, 256, cube.shape, generator=rng, device=dev,
                        dtype=torch.int32)
    cube16 = ((cube.to(torch.int32) << 8) | low).to(torch.uint16)
    alpha16 = torch.randint(0, 65536, cube.shape[:2] + (1,), generator=rng,
                            device=dev, dtype=torch.int32).to(torch.uint16)
    variants = {
        "u16 RGBA": torch.cat([cube16, alpha16], -1),
        "u8 RGBA": torch.cat([cube, cube[..., :1]], -1),
        "u8 grey": cube[..., 1:2].contiguous(),
        "u16 grey": cube16[..., :1].contiguous(),
        "1x1": ragged(cube, 1, 1),
        "ragged 1013x771": ragged(cube, 1013, 771),
        "ragged u16 RGBA 771x1013": ragged(torch.cat([cube16, alpha16], -1),
                                           771, 1013)}
    worst = {"icc_to_srgb": 0, "clut_kernel": 0}
    n = {"icc_to_srgb": [0, 0], "clut_kernel": [0, 0]}
    for name, prof in {**profiles, **luts}.items():
        tr = HICC.plan(prof)
        tab = ICC.tables_on(tr, dev)
        key, fn, plain = ("clut_kernel", ICC.clut_transform,
                          ICC.clut_transform_plain) \
            if isinstance(tr, HLUT.ClutTransform) else \
            ("icc_to_srgb", ICC.transform, ICC.transform_plain)
        imgs = {"u8 RGB cube": cube}
        if name in ("p3 v4", "curv table", "srgb") + ICC_LUT_VARIANTS:
            imgs.update(variants)
        for what, img in imgs.items():
            got = fn(img, tab)
            ref = plain(img, tab)
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"icc {name} {what}: {got.shape} "
                                     f"{got.dtype} vs {ref.shape}")
            worst[key] = max(worst[key], (got.to(torch.int32) -
                                          ref.to(torch.int32))
                             .abs().max().item())
            n[key][0] += 1
        n[key][1] += 1
    torch.cuda.synchronize()
    for key in worst:
        note_err(key, worst[key], 0, f"{n[key][0]} images over {n[key][1]} "
                 f"profiles (the 2^24 cube each; integers: no tie)")
    tr = HICC.plan(profiles[ICC_P3])
    got = ICC.transform(cube, ICC.tables_on(tr, dev)).cpu().numpy()
    model = HICC.srgb8_model(cube.cpu().numpy(), tr).astype(np.int64)
    d = np.abs(model - got)
    print(f"icc {ICC_P3} on the cube: the float64 model within {d.max()} "
          f"code on {(d > 0).mean():.4%} of values", flush=True)
    if d.max() > 1 or (d > 0).mean() > 0.03:
        raise AssertionError("icc: the cube against the float64 model")


def icc_yardstick(img: torch.Tensor, tables: torch.Tensor,
                  m: torch.Tensor) -> torch.Tensor:
    """The same transform as a few PyTorch calls on the card: the float
    model (a table gather, a float32 matmul with TF32 off, the clamp, the
    sRGB curve by torch.where / pow, the rounding)."""
    lin = torch.stack([tables[c][img[..., c].long()] for c in range(3)], -1)
    v = torch.clamp(torch.matmul(lin, m.T), 0.0, 1.0)
    e = torch.where(v <= 0.0031308, 12.92 * v,
                    1.055 * torch.pow(v, 1 / 2.4) - 0.055)
    return torch.round(e * 255.0).to(torch.uint8)


@contextlib.contextmanager
def icc_split(log: dict):
    """Time, inside api.decode, the header's ICC stream read, the host
    plan, the tables' upload and the kernel (either program), each between
    two synchronisations; summed by name."""
    saved = []

    def wrap(owner, name, key):
        fn = getattr(owner, name)

        @functools.wraps(fn)
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            log[key] = log.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        saved.append((owner, name, fn))
        setattr(owner, name, timed)
    wrap(HBICC, "read_icc_profile", "icc stream")
    wrap(HICC, "plan", "plan")
    wrap(ICC, "tables_on", "upload")
    wrap(ICC, "transform", "kernel")
    wrap(ICC, "clut_transform", "kernel")
    try:
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def icc_decode_timing(plain: bytes, stills: dict, card: str) -> dict:
    """Host ms of api.decode(..., "cuda") of the 4K Modular still without
    its profile and with each of `stills` (label -> bytes), in turns
    (without, each, each, without); the calls with a profile split in the
    same calls (icc_split): the plan's cache emptied before the turns, so
    each profile's first call plans cold and its second from the cache."""
    order = ["without", *stills, *stills, "without"]
    t = {k: [] for k in ["without", *stills]}
    split = {k: [] for k in stills}
    HICC.plan.cache_clear()
    for k in order:
        log = {}
        with no_gc(), icc_split(log) if k != "without" else \
                contextlib.nullcontext():
            t0 = time.perf_counter()
            api.decode(stills.get(k, plain), "cuda")
            t[k].append((time.perf_counter() - t0) * 1e3)
        if k != "without":
            split[k].append(log)
    base = statistics.median(t["without"])
    print(f"4k Modular decode (host clock, ms; in turns {', '.join(order)}): "
          f"without a profile {base:.1f} (median of 2) [{card}]", flush=True)
    for k in stills:
        for label, total, log in zip(("cold", "cached"), t[k], split[k]):
            parts = ", ".join(f"{n} {log[n]:.2f}" for n in
                              ("icc stream", "plan", "upload", "kernel"))
            print(f"  with {k}, plan {label}: {total:.1f} "
                  f"(+{total - base:.1f}): {parts} (each between two "
                  f"synchronisations; the ICC stream is the header's, "
                  f"read on the host), the rest "
                  f"{total - base - sum(log.values()):.1f}", flush=True)
    return {"without": base, **{k: t[k] for k in stills}}


def clut_yardstick(img: torch.Tensor, tr) -> tuple:
    """F.grid_sample's inputs for the CLUT program on img: the CLUT as a
    (1, 3, 33, 33, 33) fp32 volume (red the depth axis, blue the width) and
    each pixel's position in it, through the prelinearisation curves where
    littlecms has them (node + fraction / 65536), as a (1, 1, H, W, 3)
    grid in [-1, 1]."""
    dev = img.device
    g = HLUT.GRID
    vol = torch.from_numpy(tr.table.reshape(g, g, g, 3).astype(np.float32)
                           ).permute(3, 0, 1, 2)[None].contiguous().to(dev)
    strides = np.array([3 * g * g, 3 * g, 3])[:, None]
    pos = (tr.offs // strides + tr.fracs / 65536.0) / (g - 1) * 2 - 1
    pos = torch.from_numpy(pos.astype(np.float32)).to(dev)
    idx = img.long()
    grid = torch.stack([pos[2][idx[..., 2]], pos[1][idx[..., 1]],
                        pos[0][idx[..., 0]]], -1)[None, None].contiguous()
    return vol, grid


def grid_sample_codes(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The yardstick's one call, trilinear in fp32, then its 16-bit values
    to 8-bit codes."""
    v = torch.nn.functional.grid_sample(vol, grid, mode="bilinear",
                                        padding_mode="border",
                                        align_corners=True)
    return torch.round(v[0, :, 0].permute(1, 2, 0) / 257.0).to(torch.uint8)


def icc_phase(jobs: dict, rct: bytes, dev, card: str, ms: dict) -> dict:
    """Phase 19: the ICC kernel against its twin; the 4K Modular ICC still
    and a lossy encode(icc=) counted; S2, S3 and S4 past four channels and
    A10 past eight extra channels on the main path, held to their twins;
    each kernel at 4K by CUDA graph."""
    profiles = icc_test_profiles()
    luts = lut_test_profiles()
    p3, mab = profiles[ICC_P3], luts[ICC_LUT]
    tr = HICC.plan(p3)
    check_icc_seeded(profiles, luts, dev)
    launches = {}

    # the 4K Modular still of phase 11 (lossless: its pixels are the
    # source) with the profile in its header
    img = bench_frame(ICC_H, ICC_W)
    still = with_icc(rct, p3)
    with forbidden(ICC, ("transform_plain",)):
        got, counts = drive("main path (api.decode, 4K Modular still with "
                            "Display P3)", lambda: api.decode(still, "cuda")[0],
                            ("icc_to_srgb", "rct_inverse"))
    if counts["icc_to_srgb"] != 1:
        raise AssertionError(f"icc decode: launches {counts}")
    launches["icc_to_srgb"] = counts["icc_to_srgb"]
    plain = api.decode(rct, "cuda")[0]
    if not np.array_equal(plain, img):
        raise AssertionError("the 4K still without its profile is not its "
                             "source")
    twin = ICC.transform_plain(torch.from_numpy(plain),
                               ICC.tables_on(tr, "cpu")).numpy()
    model = HICC.srgb8_model(img, tr).astype(np.int64)
    d = np.abs(model - got)
    print(f"decode 4k Modular with Display P3: equal to the still without "
          f"its profile through the twin on the CPU "
          f"{np.array_equal(got, twin)}; the float64 model within "
          f"{d.max()} code on {(d > 0).mean():.4%} of values", flush=True)
    if not np.array_equal(got, twin) or d.max() > 1:
        raise AssertionError("icc decode against the twin / the model")

    # the same still with the table profile: the CLUT program once
    tr_lut = HICC.plan(mab)
    still_lut = with_icc(rct, mab)
    with forbidden(ICC, ("clut_transform_plain", "transform_plain")):
        got, counts = drive("main path (api.decode, 4K Modular still with "
                            "the mAB profile)",
                            lambda: api.decode(still_lut, "cuda")[0],
                            ("clut_kernel", "rct_inverse"))
    if counts["clut_kernel"] != 1:
        raise AssertionError(f"icc lut decode: launches {counts}")
    launches["clut_kernel"] = counts["clut_kernel"]
    twin = ICC.clut_transform_plain(torch.from_numpy(plain),
                                    ICC.tables_on(tr_lut, "cpu")).numpy()
    print(f"decode 4k Modular with the mAB profile: equal to the still "
          f"without its profile through the twin on the CPU "
          f"{np.array_equal(got, twin)}; changed {(got != plain).mean():.2%}"
          f" of values", flush=True)
    if not np.array_equal(got, twin):
        raise AssertionError("icc lut decode against the twin")
    icc_decode_timing(rct, {"Display P3": still, "mAB": still_lut}, card)

    # the lossy encode with the profile: the kernel, then E1-E4
    enc_want = ("icc_to_srgb", "enc_front_planes", "enc_front_blocks",
                "enc_dct_costs", "enc_gather_rows")
    with contextlib.ExitStack() as stack:
        for module, names in ICC_TWINS + ENC_TWINS:
            stack.enter_context(forbidden(module, names))
        t0 = time.perf_counter()
        ours, counts = drive("main path (api.encode, lossy, icc=Display P3)",
                             lambda: api.encode(img, lossless=False,
                                                quality=90, effort=7,
                                                icc=p3, device="cuda"),
                             enc_want)
        t_enc = time.perf_counter() - t0
    ys_b, xs_b = ICC_H // 8, ICC_W // 8
    srgb = ICC.transform_plain(torch.from_numpy(img),
                               ICC.tables_on(tr, "cpu")).numpy()
    specials = bool(ENCR._special_eligibility(srgb, ys_b, xs_b).any())
    want = {"icc_to_srgb": 1, "enc_front_planes": 1, "enc_front_blocks": 1,
            "enc_dct_costs": 7, "enc_gather_rows": 1}
    if counts != want or (KERNELS["enc_special_costs"]["fn"].launches
                          != 5 * int(specials)):
        raise AssertionError(f"icc encode: launches {counts}, expected "
                             f"{want}")
    launches["icc_to_srgb"] += counts["icc_to_srgb"]
    ref = api.encode(srgb, lossless=False, quality=90, effort=7,
                     device="cuda")
    print(f"encode 4k lossy with Display P3 on the card: {len(ours)} B in "
          f"{t_enc:.2f} s", flush=True)
    enc_same_point("4k d1.0 e7 icc=Display P3", ours, ref, srgb,
                   "the encode of the twin's sRGB pixels")

    # the lossy encode with the table profile, and its stream decoded on
    # the card (kernels 1 and 2)
    with contextlib.ExitStack() as stack:
        for module, names in ICC_TWINS + ENC_TWINS:
            stack.enter_context(forbidden(module, names))
        t0 = time.perf_counter()
        ours, counts = drive("main path (api.encode, lossy, icc=mAB)",
                             lambda: api.encode(img, lossless=False,
                                                quality=90, effort=7,
                                                icc=mab, device="cuda"),
                             ("clut_kernel",) + enc_want[1:])
        t_enc = time.perf_counter() - t0
    if counts["clut_kernel"] != 1:
        raise AssertionError(f"icc lut encode: launches {counts}")
    launches["clut_kernel"] += counts["clut_kernel"]
    with forbidden(synth, ("synth_family_plain",)), \
            forbidden(filters, ("restore_and_output_plain",)):
        back, counts = drive("main path (api.decode of the lossy icc=mAB "
                             "stream)", lambda: api.decode(ours, "cuda")[0],
                             ("synth_dct8", "restore_and_output"))
    srgb_lut = ICC.clut_transform_plain(torch.from_numpy(img),
                                        ICC.tables_on(tr_lut, "cpu")).numpy()
    p_lut, p_src = psnr(back, srgb_lut), psnr(back, img)
    print(f"encode 4k lossy with the mAB profile on the card: {len(ours)} B "
          f"in {t_enc:.2f} s; decoded on the card, PSNR {p_lut:.4f} dB "
          f"against the twin's sRGB pixels, {p_src:.4f} against the "
          f"unconverted frame", flush=True)
    if not p_lut >= 25 or not p_lut > p_src + 3:
        raise AssertionError("icc lut encode: the stream is not the "
                             "converted frame's")

    # S2, S3 and S4 on the FHD still of 6 channels; A10 on the sprite
    # animation of 13 channels (10 extra channels: two launches a frame)
    (ch6, t6), (ch13, t13) = jobs["ch6"].get(), jobs["ch13"].get()
    print(f"phase 19 streams (written in phase 3's pool): FHD {CH6_N}-"
          f"channel still {len(ch6)} B ({t6:.1f} s), {CH13_H}x{CH13_W} "
          f"animation of {3 + CH13_EXTRA} channels {len(ch13)} B "
          f"({t13:.1f} s)", flush=True)
    calls, current = {}, []
    sampled_twins = ((SAMPLE, ("box_codes_plain",)),
                     (RESIZE, ("rescale_image_plain",
                               "resize_plane_stack_plain")),
                     (PACK, ("convert_plain",)))
    with contextlib.ExitStack() as stack:
        for module, names in sampled_twins:
            stack.enter_context(forbidden(module, names))
        stack.enter_context(recorded(calls, current))

        def sampled_calls():
            current[:] = ["fhd 6ch", "thumbnail"]
            thumb = api.decode_thumbnail(ch6, "cuda")[0]
            current[:] = ["fhd 6ch", "half FIT", RGBA_8888]
            out = api.decode_sampled(ch6, CH6_W // 2, CH6_H // 2, RGBA_8888,
                                     FIT, device="cuda")[0]
            current[:] = []
            return thumb, out

        (thumb, out6), counts = drive(
            f"main path (decode_thumbnail / decode_sampled, FHD {CH6_N} "
            f"channels)", sampled_calls,
            ("box_codes", "rescale_image", "convert"))
    if counts != {"box_codes": 1, "rescale_image": 1, "convert": 1}:
        raise AssertionError(f"channels: launches {counts}")
    src6 = many_channel_frame(CH6_H, CH6_W, CH6_N)
    full = calls["box_codes", "fhd 6ch", "thumbnail"][0][0]
    if not np.array_equal(full.cpu().numpy(), src6):
        raise AssertionError("the 6-channel still does not decode to its "
                             "source")
    if thumb.shape != (-(-CH6_H // 8), -(-CH6_W // 8), CH6_N) or \
            out6.shape != (CH6_H // 2, CH6_W // 2, CH6_N):
        raise AssertionError(f"channels: {thumb.shape} {out6.shape}")
    check_sampled_kernels(calls)
    anim_calls = {"compose": [], "batch": [], "read": []}
    with contextlib.ExitStack() as stack:
        stack.enter_context(forbidden(COMPOSE, ("compose_plain",)))
        stack.enter_context(recorded_anim(anim_calls, ["ch13"]))
        (frames, _d, _i), counts = drive(
            f"main path (decode_frames, {3 + CH13_EXTRA} channels)",
            lambda: api.decode_frames(ch13, "cuda"), ("compose",))
    composed = len(anim_calls["compose"])
    if counts["compose"] != 2 * composed or not composed or \
            frames[0].shape != (CH13_H, CH13_W, 3 + CH13_EXTRA):
        raise AssertionError(f"A10 on {3 + CH13_EXTRA} channels: "
                             f"{counts['compose']} launches for {composed} "
                             f"frames")
    worst = 0
    for _label, pre, src, win, params, post_ in anim_calls["compose"]:
        twin = pre.clone()
        COMPOSE.compose_plain(twin, src, win, params)
        worst = max(worst, (twin.int() - post_.int()).abs().max().item())
    note_err("compose", worst, 0, f"{composed} composed frames of "
             f"{3 + CH13_EXTRA} channels (two launches each)")

    # timings at 4K: the ICC kernel against its twin, bound and yardstick;
    # S2, S3 and A10 past their old channel limits
    img_d = torch.from_numpy(img).to(dev)
    tab = ICC.tables_on(tr, dev)
    out = ICC.transform(img_d, tab)
    BOUND["icc_to_srgb"] = bound_of(nbytes(img_d, out),
                                    img_d.numel() // 3 * ICC_OPS)
    ms["icc_to_srgb"] = (graph_ms(lambda: ICC.transform(img_d, tab)),
                         device_ms(lambda: ICC.transform_plain(img_d, tab)))
    t32 = torch.from_numpy(tr.tables).float().to(dev)
    m32 = torch.from_numpy(tr.linear).float().to(dev)
    yard = icc_yardstick(img_d, t32, m32)
    dy = (yard.int() - out.int()).abs()
    LIBRARY_MS["icc_to_srgb"] = device_ms(
        lambda: icc_yardstick(img_d, t32, m32))
    print(f"kernel icc_to_srgb at 4K RGB8: device {ms['icc_to_srgb'][0]:.4f} "
          f"ms (CUDA graph), plain twin {ms['icc_to_srgb'][1]:.4f} ms, bound "
          f"{BOUND['icc_to_srgb'][0]:.4f} ms ({BOUND['icc_to_srgb'][1]}), "
          f"yardstick (gather, fp32 matmul, where/pow) "
          f"{LIBRARY_MS['icc_to_srgb']:.4f} ms, within {dy.max().item()} "
          f"code of the kernel on {(dy > 0).float().mean().item():.4%} "
          f"[{card}]", flush=True)
    tab = ICC.tables_on(tr_lut, dev)
    out = ICC.clut_transform(img_d, tab)
    BOUND["clut_kernel"] = bound_of(nbytes(img_d, out, tab),
                                    img_d.numel() // 3 * CLUT_OPS)
    ms["clut_kernel"] = (
        graph_ms(lambda: ICC.clut_transform(img_d, tab)),
        device_ms(lambda: ICC.clut_transform_plain(img_d, tab)))
    vol, grid = clut_yardstick(img_d, tr_lut)
    dy = (grid_sample_codes(vol, grid).int() - out.int()).abs()
    LIBRARY_MS["clut_kernel"] = device_ms(
        lambda: torch.nn.functional.grid_sample(
            vol, grid, mode="bilinear", padding_mode="border",
            align_corners=True))
    print(f"kernel clut_kernel at 4K RGB8 (mAB profile): device "
          f"{ms['clut_kernel'][0]:.4f} ms (CUDA graph), plain twin "
          f"{ms['clut_kernel'][1]:.4f} ms, bound "
          f"{BOUND['clut_kernel'][0]:.4f} ms ({BOUND['clut_kernel'][1]}), "
          f"yardstick F.grid_sample (the CLUT as a 5-D fp32 volume, "
          f"trilinear, grid precomputed) {LIBRARY_MS['clut_kernel']:.4f} ms, "
          f"its codes within {dy.max().item()} of the kernel's on "
          f"{(dy > 0).float().mean().item():.4%} [{card}]", flush=True)
    wide = {}
    rng = torch.Generator(device=dev).manual_seed(5)
    px6 = torch.randint(0, 256, (ICC_H, ICC_W, CH6_N), generator=rng,
                        device=dev, dtype=torch.int32).to(torch.uint8)
    box = SAMPLE.box_codes(px6)
    wide["box_codes"] = (graph_ms(lambda: SAMPLE.box_codes(px6)),
                         device_ms(lambda: SAMPLE.box_codes_plain(px6)),
                         bound_of(nbytes(px6, box),
                                  box.numel() * SAMPLED_OPS["box_codes"]),
                         f"4K x{CH6_N} u8 -> 480x270")
    pl = RESIZE.HR.plan(ICC_H, ICC_W, ICC_W // 2, ICC_H // 2, FIT)
    fid = int(api.ResizeFilter.MITCHELL)
    bnd = RESIZE.bands(ICC_H, ICC_W, pl, fid, dev)
    scaled = RESIZE.resample(px6, pl, bnd)
    note_err("rescale_image", (scaled.double() - RESIZE.rescale_image_plain(
        px6, ICC_W // 2, ICC_H // 2, FIT, fid).double()).abs().max().item(),
        1, f"4K x{CH6_N} u8 -> 1920x1080 Mitchell")
    bv = RESIZE.HR.band(ICC_H, pl.oh, fid, pl.y0, pl.ch)
    bh = RESIZE.HR.band(ICC_W, pl.ow, fid, pl.x0, pl.cw)
    taps = 2 * CH6_N * (int(bv.length.sum()) * ICC_W
                        + int(bh.length.sum()) * pl.ch)
    wide["rescale_image"] = (
        graph_ms(lambda: RESIZE.resample(px6, pl, bnd)),
        device_ms(lambda: RESIZE.rescale_image_plain(px6, ICC_W // 2,
                                                     ICC_H // 2, FIT, fid)),
        bound_of(nbytes(px6, scaled), taps),
        f"4K x{CH6_N} u8 -> 1920x1080 Mitchell")
    nch = 3 + CH13_EXTRA
    canvas = torch.randint(0, 256, (ICC_H, ICC_W, nch), generator=rng,
                           device=dev, dtype=torch.int32).to(torch.uint8)
    src = torch.randint(0, 256, (ICC_H, ICC_W, nch), generator=rng,
                        device=dev, dtype=torch.int32).to(torch.uint8)
    win = COMPOSE.Window(0, 0, 0, 0, ICC_W, ICC_H)
    params = np.asarray([nch, 3, CH13_EXTRA, 2, 0, 0]
                        + [2, 0, 0, 0] * CH13_EXTRA, np.int32)
    vals = ICC_W * ICC_H * nch
    wide["compose"] = (
        graph_ms(lambda: COMPOSE.compose(canvas, src, win, params)),
        device_ms(lambda: COMPOSE.compose_plain(canvas, src, win, params)),
        bound_of(3 * vals, vals * COMPOSE_OPS, F64_OPS_PER_S),
        f"4K x{nch} u8 whole-canvas BLEND ({-(-CH13_EXTRA // 8)} launches)")
    for name, (t_k, t_p, (b, by), shape) in wide.items():
        print(f"kernel {name} (widened) at {shape}: device {t_k:.4f} ms "
              f"(CUDA graph), plain twin {t_p:.4f} ms, bound {b:.4f} ms "
              f"({by}) [{card}]", flush=True)
    return launches


# ---- phase 20: the multi-device decode and encode (torch.distributed) ------

# the 4K all-DCT8 frame's rank counts: 270 block rows divide by 2 and 3, not
# by 4; one rank (this process) takes NCCL, ranks that share the one card
# take gloo (NCCL refuses two ranks on one GPU)
PAR_RUNS = ((1, "nccl"), (2, "gloo"), (3, "gloo"))
# what the sharded paths on the card must not run: their kernels' twins
PAR_TWINS = ((filters, ("restore_and_output_plain", "epf0_pass_plain")),
             (DT, ("detile_plain",)),
             (FF, ("legacy_filters_plain", "legacy_filters_batch_plain")))
PAR_TIMED = 3


@contextlib.contextmanager
def par_counted():
    """The phase's kernels' counts at 0 and every twin of its paths made to
    raise while the block runs; yields the counts, read after it."""
    fns = {"restore_and_output": filters.restore_and_output,
           "epf0_pass": filters.epf0_pass, "detile": DT.detile,
           "fused_gab_epf": FF.fused_gab_epf,
           "fused_filters2": FF.fused_filters2,
           "legacy_filters_batch": FF.legacy_filters_batch}
    for f in fns.values():
        f.launches = 0
    filters.restore_and_output.window_launches = 0
    filters.epf0_pass.window_launches = 0
    counts = {}
    with contextlib.ExitStack() as stack:
        for module, names in PAR_TWINS:
            stack.enter_context(forbidden(module, names))
        yield counts
        torch.cuda.synchronize()
    counts.update({k: f.launches for k, f in fns.items()})
    counts["window_launches"] = filters.restore_and_output.window_launches
    counts["epf0_window_launches"] = filters.epf0_pass.window_launches


@contextlib.contextmanager
def par_spans(log: dict):
    """groups.exchange_halo and groups.gather timed into log (host ms, the
    card synchronised around each call) while the block runs."""
    saved = {n: getattr(G, n) for n in ("exchange_halo", "gather")}

    def timed_(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            log[name] = log.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return run

    for n, f in saved.items():
        setattr(G, n, timed_(n, f))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(G, n, f)


def par_split(fn, runs: int = PAR_TIMED) -> dict:
    """fn() timed `runs` times with its exchanges and gathers split out:
    the medians of total, exchange, gather and compute (the rest) ms."""
    rows = []
    for _ in range(runs):
        log = {}
        with par_spans(log):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
        ex, ga = log.get("exchange_halo", 0.0), log.get("gather", 0.0)
        rows.append((total, ex, ga, total - ex - ga))
    return dict(zip(("total", "exchange", "gather", "compute"),
                    (statistics.median(c) for c in zip(*rows))))


@contextlib.contextmanager
def window_calls(calls: list):
    """kernel 2's windowed calls (arguments and output) recorded."""
    real = filters.restore_and_output

    @functools.wraps(real)
    def rec(*a, **k):
        out = real(*a, **k)
        if k.get("window") is not None:
            calls.append((a, k, out))
        return out

    filters.restore_and_output = rec
    try:
        yield
    finally:
        real.launches, real.window_launches = rec.launches, rec.window_launches
        filters.restore_and_output = real


def par_real_rank(mesh, args, cases, refs) -> dict:
    """A rank of the sharded 4K all-DCT8 frame, per case (gab, epf_iters,
    dc_smooth): the counted run (twins raise) against DCT8Frame's codes
    on the card (0 codes, every rank's whole output), each windowed kernel-2
    launch against its twin on the shard's slab, then PAR_TIMED runs split
    into compute, exchange and gather."""
    res = {"rank": mesh.rank}
    for case, ref in zip(cases, refs):
        fn = G.sharded_reconstruct_real(mesh, *case)
        calls = []
        with par_counted() as counts, window_calls(calls):
            got = fn(*args)
        diff = int((got.to(torch.int32) - torch.from_numpy(ref).to(
            got.device, torch.int32)).abs().max())
        twin = []
        for a, k, out in calls:
            plain = filters.restore_and_output_plain(*a, **k)
            d = (out.to(torch.int32) - plain.to(torch.int32)).abs()
            twin.append((int(d.max()), float((d > 0).float().mean()),
                         tuple(a[0].shape)))
        res[case] = {"diff": diff, "counts": counts, "twin": twin,
                     "times": par_split(lambda: fn(*args))}
    return res


def par_round1(mesh, data, arrays, refs) -> dict:
    """The round-1 animation's paths on this rank, counted with the twins
    made to raise: decode_frames_batch(mesh=), sharded_reconstruct of
    frame 0 and sharded_frame_reconstruct of all frames, each against the
    non-mesh path on the card (0 differences); then the block-row decode
    and the frame-axis decode (P3) timed, split."""
    ac, dc, qf, fx, fb, dist, epf, gab = arrays
    img = animation.AnimatedImage(data, mesh.device)
    rows = G.sharded_reconstruct(mesh, epf, gab)
    frames = G.sharded_frame_reconstruct(mesh, epf, gab)
    with par_counted() as counts:
        got = (animation.decode_frames_batch(img, mesh=mesh),
               rows(ac[0], dc[0], qf[0], fx[0], fb[0], dist).cpu().numpy(),
               frames(ac, dc, qf, fx, fb, dist).cpu().numpy())
    diffs = [float(np.abs(g.astype(np.float64) - r.astype(np.float64)).max())
             for g, r in zip(got, refs)]
    return {"diffs": diffs, "counts": counts,
            "times": par_split(lambda: rows(ac[0], dc[0], qf[0], fx[0],
                                            fb[0], dist)),
            "frame_times": par_split(lambda: frames(ac, dc, qf, fx, fb,
                                                    dist))}


def par_rank(mesh, real: tuple, round1: tuple = None,
             gop: tuple = None) -> dict:
    """A rank of phase 20: par_real_rank(*real), then par_round1(*round1)
    and the GOP decode and encode workers (gop: their arguments) where
    given, with its start time (the process's) beside them."""
    from jxl_coder_tpu_torch.parallel import multihost
    ready = time.time()
    res = par_real_rank(mesh, *real)
    if round1 is not None:
        res["round1"] = par_round1(mesh, *round1)
    if gop is not None:
        res["gop"] = (multihost.worker_main(mesh, *gop[0]),
                      multihost.worker_encode_main(mesh, *gop[1]))
    res["ready"] = ready
    return res


def window_timing(state, gab, epf_iters, skip, card: str) -> None:
    """Kernel 2 on the lower half of the 4K frame's rows (a 2-rank shard's
    window) beside the whole-image launch and its twin, by CUDA graph."""
    planes = dct8.synth_dct8_planes(*(state[k] for k in (
        "coeffs", "dc", "qf", "xf", "bf", "table", "igs", "quant_dc", "dcq",
        "qm_x", "qm_b")), skip)
    sigma = filters.sigma_map(state["sharp"], state["qf"],
                              float(np.float32(state["igs"])))
    H, W = planes.shape[1:]
    half = H // 2
    win = filters.Window(H, half - filters.HALO, half // 8 - 1, half, half)
    slab, sig = planes[:, win.lo:], sigma[win.sig_lo:]
    chain = (gab, epf_iters, dct8._GABW, dct8._PASS0_SCALE,
             dct8._PASS2_SCALE, "u8")
    got = filters.restore_and_output(slab, sig, *chain, window=win)
    whole = filters.restore_and_output(planes, sigma, *chain)
    if not torch.equal(got, whole[half:]):
        raise AssertionError("kernel 2's window differs from the same rows "
                             "of the whole-image launch")
    note_codes("restore_and_output", got, filters.restore_and_output_plain(
        slab, sig, *chain, window=win), False,
        f"4k window rows {half}-{H - 1} epf_iters {epf_iters}")
    t_win = graph_ms(lambda: filters.restore_and_output(slab, sig, *chain,
                                                        window=win))
    t_whole = graph_ms(lambda: filters.restore_and_output(planes, sigma,
                                                          *chain))
    t_twin = device_ms(lambda: filters.restore_and_output_plain(
        slab, sig, *chain, window=win))
    moved = nbytes(slab[:, :half + filters.HALO], sig) + half * W * 3
    bound = bound_of(moved, half * W * chain_ops(gab, epf_iters))
    print(f"kernel restore_and_output windowed: 4k rows {half}-{H - 1} of "
          f"{H} (a 2-rank shard) epf_iters {epf_iters} u8: device "
          f"{t_win:.4f} ms, the whole-image launch {t_whole:.4f} ms, plain "
          f"{t_twin:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}) [{card}]",
          flush=True)


def round1_arrays(data: bytes, frames: list, dev) -> tuple:
    """The round-1 animation's frames (their host data, as phase 16 read
    them) as the block-row and frame-axis decodes take them (numpy), with
    frame 0's distance, epf_iters and gaborish."""
    per = []
    for d in frames:
        ac, dc, qf, cx, cb, _ = LP.inputs_from_frame_data(d, dev)
        fx, fb = LP.expand_cfl(cx, cb, *qf.shape)
        per.append([t.cpu().numpy() for t in (ac.to(torch.int32), dc, qf, fx,
                                              fb)])
    rf = animation.AnimatedImage(data, dev).frames[0].header.restoration_filter
    return tuple(np.stack(a) for a in zip(*per)) + (
        frames[0].distance, rf.epf_iters or 0, rf.gab)


def par_phase(vardct: dict, round1: bytes, anim_round1: tuple,
              card: str) -> dict:
    """Phase 20: the multi-device decode and encode over torch.distributed
    on the one card (jxl_coder_tpu_torch/parallel), its ranks spawned
    after every timed phase (one rank, and the GOP runs' one process, in
    this process; the GOP runs' 2 processes in the 2 ranks); anim_round1:
    phase 16's round-1 batch and frame data.  Returns the windowed
    kernel-2 launches."""
    import torch.distributed as dist
    from jxl_coder_tpu_torch.parallel import multihost
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    data = stream(bench_frame(2160, 3840), 1.0, 2)
    args, (gab, epf_iters, skip) = dct8.arguments(data)
    state = dct8.to_device(*args, dev)
    ys, xs = args[2].shape
    print(f"phase 20: the 4K all-DCT8 frame, {ys} x {xs} blocks, gab {gab} "
          f"epf_iters {epf_iters} skip_dc_smooth {skip} [{card}]", flush=True)
    window_timing(state, gab, epf_iters, skip, card)
    # the frame at its own filters, and with EPF0 on top (epf_iters 3: the
    # JAX sharded function leaves EPF0 out, ROADMAP R23)
    cases = [(gab, epf_iters, not skip), (gab, 3, not skip)]
    refs = [dct8.DCT8Frame(gab, c[1], skip)(state).cpu().numpy()
            for c in cases]
    del state
    torch.cuda.empty_cache()
    halo = {"planes": filters.HALO * xs * 8 * 3 * 4, "sigma": xs * 4,
            "dc": xs * 3 * 4}
    print(f"halo bytes per shard edge: planes {halo['planes']:,} B (8 rows x "
          f"{xs * 8} x 3 planes x 4 B), sigma {halo['sigma']:,} B, DC "
          f"{halo['dc']:,} B; the gather {8 * ys * 8 * xs * 3:,} B of "
          f"codes", flush=True)
    # phase 16's round-1 animation (its batch and its frames' host data), at
    # 2 ranks beside the frame's
    batch, datas = anim_round1
    round1 = (round1, round1_arrays(round1, datas, dev))
    ac, dcq, qf, fx, fb, dist_, r_epf, r_gab = round1[1]
    t = [torch.from_numpy(a).to(dev) for a in (ac, dcq, qf, fx, fb)]
    xyb = [LP._filters(LP.dequant_idct(*(a[f] for a in t), dist_), t[2][f],
                       dist_, r_epf, r_gab, "f32").cpu().numpy()
           for f in range(ac.shape[0])]
    round1 += ((batch, xyb[0], np.stack(xyb)),)
    del t
    # the GOP decode of the 4K d1.0 e7 stream (4 frames a rank) and the GOP
    # encode of 4 FHD frames: 1 process (this one, no process group), then
    # in the 2 ranks beside their other work
    path = os.path.join(tempfile.mkdtemp(), "4k_d1.0_e7.jxl")
    with open(path, "wb") as f:
        f.write(vardct["4k_d1.0_e7"][2])
    gop = ((path, 4, 3), (4, 1080, 1920, 1))
    t0 = time.perf_counter()
    mesh = G.make_mesh(1, device="cuda")
    gop_runs = {1: [(multihost.worker_main(mesh, *gop[0]),
                     multihost.worker_encode_main(mesh, *gop[1]))]}
    print(f"  GOP decode and encode at 1 process: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    windows = epf0_windows = 0
    for n, backend in PAR_RUNS:
        run_cases = cases if n == 2 else cases[:1]
        real = (args, run_cases, refs[:len(run_cases)])
        t0 = time.time()
        if n == 1:
            # one rank needs no spawn: this process, a process group of one
            # over NCCL
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{multihost.free_port()}",
                world_size=1, rank=0)
            try:
                res = [par_rank(G.make_mesh(1, device="cuda"), real)]
            finally:
                dist.destroy_process_group()
        else:
            res = multihost.run_ranks(n, par_rank, real,
                                      *((round1, gop) if n == 2 else ()),
                                      backend=backend, device="cuda",
                                      timeout=300.0)
            if n == 2:
                gop_runs[2] = [r["gop"] for r in res]
        wall = time.time() - t0
        for case in run_cases:
            for r in res:
                got = r[case]
                c = got["counts"]
                windows += c["window_launches"]
                epf0_windows += c["epf0_window_launches"]
                want = {"window_launches": 1, "detile": 1,
                        "epf0_window_launches": int(case[1] >= 3)}
                if any(c[k] != v for k, v in want.items()):
                    raise AssertionError(f"{n} ranks {case} rank "
                                         f"{r['rank']}: launches {c}")
                if got["diff"]:
                    raise AssertionError(f"{n} ranks {case} rank {r['rank']}: "
                                         f"{got['diff']} codes from DCT8Frame")
                for d, share, shape in got["twin"]:
                    note_err("restore_and_output", d, 1,
                             f"window on a {shape} slab, {n} ranks, rank "
                             f"{r['rank']} (differing share {share:.2g})")
                    if share >= 1e-3:
                        raise AssertionError(f"window twin share {share}")
                t = got["times"]
                print(f"sharded_reconstruct_real 4k {n} ranks ({backend}) "
                      f"epf_iters {case[1]} rank {r['rank']}: 0 codes from "
                      f"DCT8Frame; host ms total {t['total']:.2f} = compute "
                      f"{t['compute']:.2f} + exchange {t['exchange']:.2f} + "
                      f"gather {t['gather']:.2f}; launches {c} [{card}]",
                      flush=True)
        for r in res if n == 2 else ():
            r1 = r["round1"]
            c = r1["counts"]
            if max(r1["diffs"]) != 0 or c["legacy_filters_batch"] != 1 or \
                    c["fused_gab_epf"] < 1:
                raise AssertionError(f"round-1 rank {r['rank']}: diffs "
                                     f"{r1['diffs']}, launches {c}")
            tt, tf = r1["times"], r1["frame_times"]
            print(f"round-1 {ROUND1_FRAMES} x {ROUND1_H}x{ROUND1_W} at 2 "
                  f"ranks rank {r['rank']}: decode_frames_batch(mesh=), "
                  f"sharded_reconstruct and sharded_frame_reconstruct equal "
                  f"to the non-mesh path (0); launches {c}; "
                  f"sharded_reconstruct host ms {tt['total']:.2f} = compute "
                  f"{tt['compute']:.2f} + exchange {tt['exchange']:.2f} + "
                  f"gather {tt['gather']:.2f}; sharded_frame_reconstruct "
                  f"host ms {tf['total']:.2f} = compute {tf['compute']:.2f} "
                  f"+ exchange {tf['exchange']:.2f} + gather "
                  f"{tf['gather']:.2f} [{card}]", flush=True)
        print(f"  {n} ranks ({backend}): {wall:.1f} s, the last rank ready "
              f"after {max(r['ready'] for r in res) - t0:.1f} s", flush=True)

    note = "ranks sharing one card: contention, not scaling"
    dec = multihost.decode_report(*([d for d, _ in gop_runs[k]]
                                    for k in (1, 2)), "cuda")
    for c in dec["launches"]:
        if c["restore_and_output"] < 1 or c["synth_dct8"] < 1:
            raise AssertionError(f"GOP decode launches {c}")
    print(f"multihost GOP decode 4k d1.0 e7, 4 frames a rank: "
          f"{dec['fps_1proc']:.2f} f/s @1 process, {dec['fps_nproc']:.2f} "
          f"f/s @2, efficiency {dec['efficiency']:.3f} ({note}); launches "
          f"{dec['launches']} [{card}]", flush=True)
    enc = multihost.encode_report(*([e for _, e in gop_runs[k]]
                                    for k in (1, 2)), "cuda")
    for c in enc["launches"]:
        if min(c[k] for k in ("enc_front_planes", "enc_front_blocks",
                              "enc_dct_costs", "enc_gather_rows")) < 1:
            raise AssertionError(f"GOP encode launches {c}")
    print(f"multihost GOP encode 4 FHD frames (quality 90, effort 5): "
          f"byte-identical {enc['byte_identical']}, {enc['fps_1proc']:.3f} "
          f"f/s @1 process, {enc['fps_nproc']:.3f} f/s @2, efficiency "
          f"{enc['efficiency']:.3f} ({note}); launches {enc['launches']} "
          f"[{card}]", flush=True)
    print(f"phase 20 (multi-device) took {time.perf_counter() - t_phase:.1f} "
          f"s", flush=True)
    return {"restore_and_output": windows, "epf0_pass": epf0_windows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = smi()
    print(f"card: {card}", flush=True)
    start = time.perf_counter()

    def phase_done(name: str) -> None:
        print(f"phase {name} done at {time.perf_counter() - start:.1f} s",
              flush=True)

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    # 2. build, one nvcc per source and g++ for the host codec, all at once
    t0 = time.perf_counter()
    sources = ("synth", "filters", "fused_filters", "detile", "entropy",
               "modular", "post", "overlay", "sample", "pixel_ops", "compose",
               "jpeg", "encode", "icc")
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        host = pool.submit(_build.load_host, "hostcodec")
        list(pool.map(_build.load, sources))
        host.result()
    print(f"build: nvcc sm_90a, {len(sources)} sources, and g++ for the host "
          f"codec in {time.perf_counter() - t0:.2f} s", flush=True)
    for name in ("synth", "filters", "fused_filters", "entropy", "modular",
                 "post", "overlay", "sample", "pixel_ops", "compose", "jpeg",
                 "encode", "icc"):
        ptxas_report(name)

    phase_done("2 (build)")

    # 3. streams; the post-stage streams (phase 12) and their references
    # start at once in worker processes, as many as the card's host has
    # cores, at a lower priority than the main thread's encodes and checks
    pool = multiprocessing.get_context("spawn").Pool(
        os.cpu_count() or 8, initializer=os.nice, initargs=(10,))
    atexit.register(pool.terminate)
    # the longest jobs first, so that phase 5b's wait for the pool's last
    # job is short: phase 14's 4K text, phase 12's 4K noise + PQ stream
    # (the first of POST_STREAMS), phase 16's 4K two-pass still (the first
    # of its jobs), then phase 17's JPEGs, their round trips and oracles
    overlay_jobs = {"4k_text": pool.apply_async(overlay_job, ("4k_text",))}
    post_jobs = {label: pool.apply_async(post_job, (label,))
                 for label in POST_STREAMS}
    anim_jobs = start_anim_jobs(pool)
    jpeg_jobs = start_jpeg_jobs(pool)
    enc_jobs = start_enc_jobs(pool)
    streams = {"4k_d1.0_e7": (2160, 3840, stream(bench_frame(2160, 3840), 1.0, 7)),
               "fhd_d4.0_e7": (1080, 1920, stream(bench_frame(1080, 1920), 4.0, 7)),
               "sharp_d1.0_e7": (517, 771, stream(sharp_frame(517, 771), 1.0, 7)),
               # the 16-bit output path of the same decode
               "16bit_d1.0_e5": (480, 720, stream(bench_frame(480, 720), 1.0, 5, True)),
               # distance 0.1: the DCT8 family is int8 with an exception list
               "sharp_d0.1_e7": (256, 384, stream(sharp_frame(256, 384), 0.1, 7)),
               # two AC passes (progressive), and one section for the frame
               "waves_d1.0_e7_two_passes": (256, 320, stream(
                   waves_frame(256, 320), 1.0, 7, progressive=True)),
               "waves_d1.0_e7_single_section": (200, 232, stream(
                   waves_frame(200, 232), 1.0, 7))}

    # the phase 14 streams (patches, splines, LF and reference frames) and
    # their float64 host decodes, the 4K d1.0 e7 stream cached above
    overlay_jobs.update({label: pool.apply_async(overlay_job, (label,))
                         for label in OVERLAY_STREAMS if label not in
                         overlay_jobs})

    # the entropy kernel on three small streams (many groups, two passes,
    # one section); its plain twin on the same tables in worker processes
    # meanwhile (one step per token: seconds), collected before the
    # timings.  At 4K the kernel is held to the host route's coefficients
    # bit for bit (phase 6), and every stream's decode to the host route's
    # pixels (phase 5); the twin took ~112 s of a worker at 4K and 55-69 s
    # on the 16-bit and d0.1 streams, and is not run there
    twins = start_twins(pool, {k: streams[k][2] for k in (
        "sharp_d1.0_e7", "waves_d1.0_e7_two_passes",
        "waves_d1.0_e7_single_section")}, dev)
    # the Modular streams, encoded and decoded on the CPU route in the same
    # workers once the twins free them; collected in phase 11
    modular_jobs = {label: pool.apply_async(modular_job, (label,))
                    for label in MODULAR_STREAMS}
    # phase 19's streams, last
    icc_jobs = start_icc_jobs(pool)

    phase_done("3 (streams)")

    # 4. kernel vs twin on the card
    check_synth_all_strategies(dev)
    check_filters_tiny(dev)
    frames = {}   # label: (epf_iters, has a DCT8 family)
    for label, (h, w, data) in streams.items():
        cfg, inp = prepared(data, dev)
        print(f"stream {label}: {w}x{h} families "
              f"{[(f.sid, int(f.coef.shape[0]), str(f.coef.dtype)[6:], synth.n_fixes(f)) for f in inp.families]} "
              f"gab {cfg.gab} epf_iters {cfg.epf_iters} bits {cfg.bits}",
              flush=True)
        if label.startswith("sharp_d1") and not any(f.special
                                                    for f in inp.families):
            raise AssertionError("the sharp stream has no special family")
        if label.startswith("sharp_d0.1") and not any(
                synth.is_dct8(f) and synth.n_fixes(f) for f in inp.families):
            raise AssertionError("the d0.1 stream's DCT8 family has no "
                                 "exception list")
        frames[label] = (cfg.epf_iters, any(synth.is_dct8(f)
                                            for f in inp.families))
        check_synth(cfg, inp, label)
        planes = torch.zeros((3, cfg.H8, cfg.W8), device=dev)
        for fam in inp.families:
            synth.synth_family(planes, fam, inp.dc, inp.qm)
        sigma = filters.sigma_map(inp.sharp, inp.qf, inp.igs)
        check_filters(planes[:, :h, :w], sigma, cfg, label)
        if label.startswith("4k"):
            check_filters(planes[:, :2160, :3833], sigma, cfg,
                          "4k crop 2160x3833")
    torch.cuda.synchronize()

    phase_done("4 (kernels against twins)")

    # 5. the main path, counted, and each frame's own launches
    frame_kernels = ("synth_family", "synth_dct8", "restore_and_output",
                     "epf0_pass")

    def main_path():
        outs, per_frame = {}, {}
        for label, (_h, _w, data) in streams.items():
            before = {k: KERNELS[k]["fn"].launches for k in frame_kernels}
            outs[label] = api.decode(data, device="cuda")[0]
            per_frame[label] = {k: KERNELS[k]["fn"].launches - before[k]
                                for k in frame_kernels}
        return outs, per_frame

    (outs, per_frame), launches = drive("main path (api.decode)", main_path,
                                        frame_kernels)
    for label, counts in per_frame.items():
        iters, has_dct8 = frames[label]
        want = {"restore_and_output": 1, "epf0_pass": int(iters >= 3),
                "synth_dct8": int(has_dct8)}
        print(f"frame {label} (epf_iters {iters}) launches: {counts}",
              flush=True)
        if any(counts[k] != n for k, n in want.items()):
            raise AssertionError(f"{label}: launches {counts}, expected {want}")
    for label, (h, w, data) in streams.items():
        t0 = time.perf_counter()
        ref = reference.decode_float64(data)
        th = time.perf_counter() - t0
        got = outs[label]
        if got.shape != (h, w, 3) or got.dtype != ref.dtype or \
                got.shape != ref.shape:
            raise AssertionError(f"{label}: {got.shape} {got.dtype} vs host "
                                 f"{ref.shape} {ref.dtype}")
        d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
        frac = float((d > 0).mean())
        print(f"decode {label}: {got.dtype} vs float64 host decoder max "
              f"{d.max()} code, differing share {frac:.3g} (host decode "
              f"{th:.1f} s)", flush=True)
        if got.dtype == np.uint16:
            if d.max() > U16_TOL:
                raise AssertionError(f"{label}: decode outside {U16_TOL} codes")
        elif d.max() > 1 or frac >= 1e-3:
            raise AssertionError(f"{label}: decode outside 1 code / 0.1%")

    phase_done("5 (the main path)")

    # 5b. the main path with the AC entropy decode on the card, counted;
    # then the kernel against its twin on the small streams and at 4K
    launches["decode_pass_groups"] = entropy_main_path(streams, outs)
    twin_s = check_twins(twins)
    pool.close()
    pool.join()

    phase_done("5b (the device entropy route; the workers joined)")

    # 6. timings at 4K
    h, w, data = streams["4k_d1.0_e7"]
    mp = h * w / 1e6
    cfg, inp = prepared(data, dev)
    frame = VarDCTFrame(cfg)
    stage_ms = cuda_ms(lambda: frame(inp))
    busy_ms = profile_stage(frame, inp)
    # the wall time is bound by the host's ~30 launches per frame and
    # spreads with the host; the device-busy time is the card's own
    print(f"stage 4k device half (synth+filters+sRGB8, inputs resident): "
          f"device busy {busy_ms:.3f} ms = {mp / busy_ms * 1e3:.1f} MP/s; "
          f"wall {stage_ms:.3f} ms = {mp / stage_ms * 1e3:.1f} MP/s, card "
          f"busy {busy_ms / stage_ms:.1%} of it [{card}]", flush=True)
    layers = decode_layers(data, mp, card)

    planes, sigma = synthesized(cfg, inp)
    xyb = planes[:, :h, :w]
    ms = {}
    entropy_4k(data, dev, card, ms, ("sharp_d1.0_e7",
                                     streams["sharp_d1.0_e7"][2],
                                     twin_s["sharp_d1.0_e7"]), layers)
    synth_timings(cfg, inp, planes, card, ms)
    px = h * w
    note_bound("restore_and_output", nbytes(xyb, sigma) + 3 * px,
               px * chain_ops(cfg.gab, cfg.epf_iters))
    chain_args = (xyb, sigma, cfg.gab, cfg.epf_iters, cfg.gabw,
                  cfg.pass0_scale, cfg.pass2_scale, "u8")
    ms["restore_and_output"] = (
        device_ms(lambda: filters.restore_and_output(*chain_args)),
        device_ms(lambda: filters.restore_and_output_plain(*chain_args)))
    print(f"kernel restore_and_output at 4k epf_iters {cfg.epf_iters} u8 "
          f"(one launch): device {ms['restore_and_output'][0]:.4f} ms, plain "
          f"{ms['restore_and_output'][1]:.3f} ms, bound "
          f"{BOUND['restore_and_output'][0]:.4f} ms [{card}]", flush=True)
    fhd_timings(streams["fhd_d4.0_e7"][2], dev, card, ms)

    phase_done("6 (timings at 4K)")

    # 7-9. the round-1 codec, the real-format fused filters, timings
    launches.update(legacy_codec(dev))
    launches.update(real_fused(xyb, sigma, cfg))
    legacy_timings(dev, card, ms)
    fused_timings(xyb, sigma, cfg, card, ms)

    phase_done("7-9 (round-1 codec, fused filters)")

    # 10. the DCT8-only frame path and kernel 7 (the filter and output
    # kernels' counts stay those of the main path, phase 5)
    launches["detile"] = dct8_phase(dev, card, ms)["detile"]

    phase_done("10 (the DCT8 path)")

    # 11. the Modular decode: the host's channel decode, then the inverse
    # transforms on the card (csrc/modular.cu) and the output
    modular = modular_phase(modular_jobs, dev, card, ms)
    launches.update({k: modular[k] for k in MODULAR_KERNELS})

    phase_done("11 (the Modular decode)")

    # 12. the VarDCT post stages: noise, upsampling and the output encodings
    # (csrc/post.cu), and the extra channels
    post_counts = post_phase(post_jobs, dev, card, ms)
    launches.update({k: post_counts[k] for k in POST_KERNELS})
    phase_done("12 (the post stages)")

    # 13. api.decode_batch: the host halves on a worker pool, overlapped
    # with the card's uploads, device halves and downloads
    batch_phase(streams, modular["streams"], post_counts["streams"], card)
    phase_done("13 (decode_batch)")

    # 14. patches, splines, reference-only and LF frames: the frame walk and
    # the overlay kernels (csrc/overlay.cu)
    overlay = overlay_phase(overlay_jobs, streams, modular["streams"], dev,
                            card, ms)
    launches.update({k: overlay[k] for k in OVERLAY_KERNELS})
    phase_done("14 (patches, splines, LF and reference frames)")

    # 15. the sampled decode: the thumbnail, the quarter-scale route and the
    # pixel ops (csrc/post.cu's down pool, csrc/sample.cu, csrc/pixel_ops.cu)
    sampled = sampled_phase({
        "4k_d1.0_e7": streams["4k_d1.0_e7"][2],
        "4k_rgba16_noise_pq": post_counts["streams"]["4k_rgba16_noise_pq"],
        "4k_text": overlay["streams"]["4k_text"],
        "4k_rct": modular["streams"]["4k_rct"]}, card, ms)
    launches.update({k: sampled[k] for k in SAMPLED_KERNELS})
    phase_done("15 (the sampled decode)")

    # 16. animation (the frame composition, csrc/compose.cu; the round-1
    # batch, kernel 6 with a frame axis), progressive and truncated decode
    anim = anim_phase(anim_jobs, card, ms)
    launches.update({k: anim[k] for k in ANIM_KERNELS})
    phase_done("16 (animation, progressive and truncated)")

    # 17. the JPEG routes: the 4:4:4 frame's A7 "ycbcr", and J1 and J2
    # (csrc/jpeg.cu) for a subsampled JPEG and the round-1 container
    jpeg = jpeg_phase(jpeg_jobs, streams["fhd_d4.0_e7"][2], card, ms)
    launches.update({k: jpeg[k] for k in JPEG_KERNELS})
    phase_done("17 (the JPEG routes)")

    # 18. the encoders: api.encode's lossy front E1-E4 (csrc/encode.cu) and
    # its lossless route, AnimatedEncoder
    enc = enc_phase(enc_jobs, streams, overlay["streams"]["4k_text"],
                    [j.get() for j in anim_jobs["frames"]], card, ms)
    launches.update({k: enc[k] for k in ENC_KERNELS})
    phase_done("18 (the encoders)")

    # 19. the ICC step (csrc/icc.cu) on the Modular decode and the lossy
    # encode; S2, S3, S4 and A10 past their old channel limits
    launches.update(icc_phase(icc_jobs, modular["streams"]["4k_rct"], dev,
                              card, ms))
    phase_done("19 (the ICC step, any channel count)")

    # 20. the multi-device decode and encode: block rows with halo
    # exchange (kernel 2 in a row window), the frame axis, the GOP decode
    # and encode, in ranks spawned now that no timed phase runs
    windows = par_phase(streams, anim_jobs["round1"].get(), anim["round1"],
                        card)
    phase_done("20 (multi-device)")

    def row(k, spec):
        r = {"name": k, "route": "cuda", "source": spec["source"],
             "replaces": spec["replaces"], "launches": launches[k],
             "max_abs_err": ERR[k], "ms": ms[k][0], "plain_ms": ms[k][1],
             "bound_ms": BOUND[k][0], "bound_by": BOUND[k][1],
             "library_ms": LIBRARY_MS[k]}
        if k in windows:
            # the row-window launches of phase 20's ranks
            r["window_launches"] = windows[k]
        return r

    print(f"profiler: {PROFILER['failed_s']:.1f} s in the tries that found "
          f"no whole profile, {PROFILER['skipped']} later calls skipped it",
          flush=True)
    print(json.dumps({"kernels": [row(k, spec)
                                  for k, spec in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
