#!/usr/bin/env python3
"""Drive the l3c_torch codec and its serving entry points on one NVIDIA
card and check them.

    python3 chip_smoke.py      # exits 0 only if every phase holds

Phases (each raises on failure; none carries on after another failed):
  1. device   card name / power limit; build the CUDA kernels (nvcc, one
              process per source, in parallel), print registers / spills
  2. forward  load the r5b checkpoint (flax msgpack, read without msgpack)
              at full cr.cf width; theory bpsp of 8 images of 512x512 (the
              bench.py image recipe); GPU vs CPU bpsp on a 64x64 crop
  3. codec    the main path with every kernel launch count set to 0 and
              the int_coder row/lookup builders counted on CUDA tensors:
              and the plain pack / top-k functions counted on CUDA tensors:
              TorchBitcoding.encode_batch (fbatch 8, balanced, topk 4) ->
              v8 files -> decode_batch, which also builds the scale-0 v7
              float rows; asserts bit-exact, 4 x rans_encode, 9 x
              rans_decode and 6 x pack_int, no row/lookup and no plain pack
              call on the card; prints file vs theory bpsp and enc/dec
              times; the canary on card and CPU, and K3/K4 held to
              int_coder on the canary's IntParams at every symbol value
  4. kernels  each kernel against its plain PyTorch version on the card at
              the main path's shapes and inputs: K1/K2 <= 1 step (coarse)
              / <= 2 steps on well-conditioned rows (fine) on the decoded
              scale-0 parameters of each channel, with the counts of
              entries 0, 1, 2 and more steps off; again at ragged sizes
              (P no multiple of a tile, less than a tile, 1), from a base
              off the 16-byte boundary and at (K, L) = (3, 25); their
              special-function floor; K3/K4 in every
              mode (uniform, bn, RGB coarse and fine per channel) exact:
              lengths, used words and symbols identical; K5 on the round's
              classifier outputs at the three scales' shapes, topk 4 and
              0: the selected components exact, every output within one
              step in <= 1e-3 of the entries; times by CUDA events (K3/K4
              /K5 records: per launch, averaged over the round); then
              K3/K4/K5 again, held the same way, at the layouts phase cli
              codes with: fbatch 8 with the size profile (T up to 16384)
              and all K = 10 components, and fbatch 1 balanced top-4 (the
              plain versions run once there, not timed); K6 forward and
              backward at shapes around its tile (one pixel, ragged tiles,
              HW % 4 != 0, K = 3 and 10, C = 3 with lambda and C = 5)
              against the card's plain version, every element within the
              tight bound
  5. cli      the serving entry points at full width on 8 seeded 512x512
              PNGs written by the port's writer: cli.l3c enc then dec of
              one (decoded PNG == source); cli.test (theory bpsp, equal to
              phase forward's) and cli.test --write_to_files
              --compare_theory (size profile, all 10 components, group 8,
              bit-exact gate); cli.test of one 509x383 PNG, its 3 K6
              launches held to the plain version; a stage_batch ->
              encode_batch(staged=) -> device-resident decode ->
              verify_batch round (flag true, hash == the numpy hash of
              the source pixels); every call has the launch counts set
              to 0 before it and read after it,
              and they must be exactly its path's (an encode 4 x K3 and
              3 x K5, a decode 9 x K4 and 3 x K5, a new codec object's
              canary 2 x K5, 2 x K3, 7 x K4; an image's theory bpsp
              3 x K6 forward)
  6. profile  device time by op and by kernel over one more encode+decode
              round (torch.profiler), and the device's busy share
  7. stages   the plain-PyTorch device stages the baselines, sampling and
              the heavy summaries added, on 8 x 512^2, timed against their
              bounds: bicubic_downsample_x2, dmll.sample and
              mean_symbol_probs (L = 256) on r5b's scale-0 mixture
     sample   cli.test --sample with r5b on two of the 512x512 PNGs: the
              JAX package's file names, three scale sets each, uint8 of
              the image's shape; only the theory bpsp's K6 launches
  8. serve    bench.py's serving configuration, in float32 and in
              bfloat16 (r5b's parameters, the conv stacks in bf16): theory
              and file bpsp of the 8 images, a bit-exact round at fbatch 8
              and at fbatch 1, then its three shapes through the async
              pairs (encode_batch_async / _finish, decode_batch_async /
              _finish, verify_batch_async / _finish): phase-split,
              duplex and device-resident duplex, depth 2, 4 rounds after
              a warm-up; every round bit-exact, its files byte-identical
              to encode_batch's, its launches exactly an encode's and a
              decode's; MP/s, median round, device-busy share
  9. limits   every kernel where the JAX package's sizes pass its fast
              variant (K6 at q.C = 9 and 16; K1-K6 at K = 12 and 16; K1
              and K3/K4 at L = 40), 2 x 64^2 pixels, against its plain
              version at the main path's bounds (K3/K4 exact, round
              trip), each timed beside its plain version and bound (K3/K4
              with their variant, generic or tiled, NS and T); then cr.cf
              at full width with K = 16 from fresh seeded weights on the
              8 images: one size-profile round (top-k 0), bit-exact,
              launch-counted, every bn and RGB K3/K4 launch the generic
              variant (the launchers' arguments read), each launch held
              to its plain version and timed
 10. train    training through cli.train.main at full cr.cf width, batch
              16 x 128^2 (oi_offline.cf) on seeded PNGs: K6 (the mixture
              NLL, forward and backward) against its plain version on r5b's
              outputs at the three scales, timed by CUDA events around one
              call as the other kernels are (beside the times so taken of
              K6 as one thread a pixel, and the bounds) and by device time
              (20 launches queued behind a sleeping kernel, L2 flushed
              between them); r5b resumed strictly (params, nu, count,
              step) and trained 20 steps (a persistent checkpoint every
              5, for phase host's SWA), the first
              loss equal to the eval forward's; that checkpoint codes a
              512x512 image through cli.l3c bit-exactly; 25 steps from a
              fresh initialisation from each of three seeds lower the
              validation bpsp in at least two; every step
              exactly 3 + 3 K6 launches and no plain nll on the card; the
              resumed run with --log_train_heavy 10: the heavy summaries'
              tags in a recording writer, their activation counts and p_x
              / p_y distributions held, each heavy step timed; step
              time, peak memory and one profiled step by kind; r5b resumed
              in bfloat16 (-p compute_dtype='bfloat16') for 8 steps, the
              first loss equal to the bf16 eval forward's, its step time
              and profiled step, and every convolution's output and
              weight gradient equal over two runs (deterministic cuDNN)
 11. baselines  cr_rgb.cf and cr_rgb_shared.cf at full width from fresh
              weights, each trained 30 steps through cli.train (the
              validation bpsp must fall; K6 on C = 3 with lambda at every
              scale); cr_rgb through cli.test (theory), cli.test
              --write_to_files (size profile, bit-exact gate) and a
              balanced top-4 fbatch 8 round of the 8 images: bit-exact,
              exactly 4 K3, 19 K4 and 6 K5 (K3/K4 in RGB modes at every
              scale, unit 0 at L = 256 through the generic variants), no
              plain row/lookup/pack on the card, its time and device time;
              each of that round's kernels and K6 on its training forward
              against the plain version and timed (the `baselines`
              records); unit 0 alone (K4 generic uniform at L = 256) at
              balanced and at size (--write_to_files'), held and timed with
              NS and T; cli.test --sample of it; cr_rgb_shared through
              cli.test --recursive auto (three recursions), its
              non-recursive round (unit 0 the whole x2-downsampled image)
              and its unit 0 the same way
 12. host     the host codec (format v1: the network and the parameter
              pack on the card, rANS in C++ on the host) and the host
              tools, launch-counted (none of the kernels runs on them):
              r5b through codec.bitcoding.Bitcoding, float32 on two of the
              8 images and bfloat16 on one, bit-exact, file bpsp against
              theory and against the v8 size profile's, per image the
              encode and decode ms split into forward, get_P (card,
              synchronised), the copy to the host and the entropy coder,
              the device-busy share of a round, dmll.pack_coder_params'
              ms against its bound; cli.l3c enc/dec and cli.test
              --write_to_files with --codec_backend host, and cli.l3c dec
              of a v8 file through the same version dispatch; phase
              baselines' cr_rgb coded through the host backend; r5b
              written in the reference's .pt layout and converted by
              cli.convert (every leaf bitwise r5b's, cli.test's theory
              bpsp r5b's); tools.swa over phase train's resumed run's
              persistent checkpoints (restores, codes bit-exactly);
              cli.classic --no_png over the 8 PNGs (.medl bpsp, ms an
              image); the host CPU's model name beside every host time
 13. parallel the parallel paths (l3c_torch/parallel) on the one card,
              two ranks or slots on it where a path has several, each
              launch-counted: cli.train as one NCCL rank under the L3C_*
              variables in a subprocess (phase train's first 5 losses and
              its step-5 checkpoint bit for bit, DDP's wrapper and the
              nccl backend recorded); two gloo ranks on the card
              (parallel.spawn) training r5b 3 steps at lr 5e-6 on 8 of the
              same 16 x 128^2 crops each, against the single-process
              Trainer on all 16 (loss 1e-5 relative, parameters rtol 2e-4
              / atol 2e-6, the ranks' replicas equal, 3 + 3 K6 launches a
              rank a step); CodecFanout over two slots on 16 x 512^2
              (bench_images' 8 and 8 from seed 1), decoded on the slots
              rotated: bit-exact, each file byte-identical to one codec's,
              8 x K3 / 18 x K4 / 12 x K5 and no plain row/lookup/pack on
              the card, both slots used, mixed cpu + cuda slots refused,
              its MP/s beside phase codec's; eval_testset_sharded over two
              slots (the 8, and a ragged 3) within 1e-5 of the per-image
              mean; spatial_bpsp of a 2048 x 512 image in two slabs against
              one at halo 512 (1e-4; halo 1024 on 4096 x 512 if that
              misses), the gap to the unsharded forward at halos 128, 256
              and 512 and each run's time; cli.test --spatial_shard (rtol
              0.05 of auto-crop, the tester's cache engaged) and cli.test
              --write_to_files --fanout (bit-exact, the files of the run
              without --fanout) with two slots
 14. prep     data prep on this machine (the port uses no Pillow): every
              fixture of
              l3c_torch/data/fixtures/prep (baseline JPEG at 4:4:4, 4:2:2
              and 4:2:0, restart markers, grey, progressive; 16-bit,
              Adam7, palette and grey PNG) decoded to Pillow's pixel
              digests (expected.json), the truncated JPEG refused with the
              reason; cli.prep_pipeline --inp_dir over them: the JAX
              pipeline's kept lists, output pixels and cache listing;
              --offline without the corpus's packages: every source
              reported missing, empty splits; cli.train resuming r5b 5
              steps on the prepared train/ (validating on val/ at step 5):
              finite losses, exactly 21 K6 forward and 15 backward
              launches, the step-5 checkpoint restoring strictly;
              cli.classic with the optimized-PNG column over the 8 bench
              PNGs, its byte counts Pillow's where this host's zlib is the
              one expected.json was made with; on the rate fixture (one
              1024 x 768 baseline JPEG, l3c_torch/data/fixtures/rate) the
              host's JPEG decode and Lanczos rates and prep_pipeline
              --inp_dir --min_res 512's images/s over 32 copies with one
              worker and with one per CPU, the host CPU named
 15. synth    the procedural source families (data/synth.py) on this
              machine's host, in numpy as in JAX (the port uses no
              Pillow or scipy): the seed-1 256^2 tile of each of the 33 families and
              two jpegtex tiles against l3c_torch/data/fixtures/synth
              (the JAX package's pixels), bit for bit where this host's
              numpy probe is the fixtures', else within one grey level
              with the count of such pixels printed a family; a 200 x 136
              cut through the JPEG round trip at q 8 and 90: the encoder's
              file Pillow's byte for byte, the decoded pixels Pillow's;
              the encoder's and decoder's MP/s over the 33 tiles; then
              prep_pipeline --offline --synth_families 33 --synth_tiles 2
              --tile 256 in a fresh process: 66 x_synth_* train tiles,
              the cache listing them, their pixels the JAX pipeline's
              (digests, same rule), tiles/s and the slowest five
              families with the host CPU named; cli.train resuming r5b 5
              steps on that corpus, validating on two synth tiles held out
              (other seeds): finite losses, exactly 21 K6 forward and 15
              backward launches, the step-5 checkpoint restoring strictly
 16. formats  the loader's other formats on this machine's host (no
              Pillow): every fixture of l3c_torch/data/fixtures/formats
              (progressive JPEG 4:2:0, 4:4:4 with restarts and grey, CMYK
              JPEG, lossy WebP with and without alpha, lossless WebP with
              and without colour indexing, an animated WebP's first
              frame, 8-bit grey BMP, 16-bit and ASCII PNM) to Pillow's
              mode, size and pixel digest (expected.json); cli.l3c enc /
              dec of the progressive JPEG and the lossy WebP (r5b, cr.cf,
              balanced top-4) bit-exact against the loader's pixels, with
              exact launch counts; cli.test --write_to_files
              --compare_theory over the folder (every serving kernel
              launched); prep_pipeline --inp_dir over it: the JAX
              pipeline's outputs; the host's decode MP/s of a 1024 x 768
              progressive JPEG, a 1024 x 768 lossy WebP and a 256 x 192
              lossless WebP (l3c_torch/data/fixtures/formats_rate), each
              held to its digest, the host CPU named
 17. damaged  damaged and partly refined files on this machine's host
              (no Pillow): every fixture of l3c_torch/data/fixtures/damaged
              (corrupt entropy data in baseline, restart and progressive
              JPEGs, one above 64 KiB; a scan cut short with EOI; a wrong
              RST; progressive files block smoothing completes; a block
              outside the inverse DCT's range; a PNG whose IDAT CRC is
              wrong; arithmetic-coded and lossless JPEG, a float PNM, a
              4-bit BMP with a grey palette) to Pillow's mode, size and
              pixel digest
              (expected.json), every file of damaged_refused refused;
              where this host has Pillow, how many fixtures its decode
              equals (reported, not held); cli.l3c enc / dec of the
              damaged baseline JPEG and the PNG bit-exact against the
              loader's pixels with exact launch counts; cli.test
              --write_to_files --compare_theory over the folder; prep over
              it: the JAX pipeline's outputs; the host's decode MP/s of
              the clean 1024 x 768 baseline and progressive JPEGs and of
              a damaged copy of each (held to Pillow's digest), one call
 18. pillow_formats  the formats Pillow opens beyond those (GIF, TIFF,
              TGA, ICO, CUR, PCX, SGI, QOI, IM, MSP, SUN, PSD, DDS, DIB,
              JPEG 2000; l3c_torch/data/fixtures/pillow_formats) to
              Pillow's format, mode, size and pixel digest, AVIF (Pillow's
              default save, its AV1 frame deblocked) among them; cli.l3c
              enc / dec of a
              GIF and an LZW TIFF bit-exact with exact launch counts;
              cli.test --write_to_files --compare_theory over the folder
              (its listing keeps a GIF named .png and a TIFF named .jpg,
              as the JAX listing does) and on one TIFF alone, K3 to K6
              launched; the listing-cache CLI with --min_size: the JAX
              listing; the PNGs cli.l3c dec wrote held to this host's
              Pillow's default save (image data and IDAT split; whole
              bytes counted, with both zlib versions) in a child process;
              the host's GIF and TIFF decode MP/s
 19. jpeg2000 JPEG 2000 and ICNS on this machine's host (no Pillow):
              every file of l3c_torch/data/fixtures/jpeg2000 and
              jpeg2000_coding (JP2 and raw codestreams, 5/3 and 9/7,
              tiles, precincts, layers, every code-block style bit,
              SOP / EPH / TLM / PLT / POC / PPT / PPM, ROI, sYCC, CMYK,
              palettes, 4 to 16 bits, ICNS with RLE, PNG and JPEG 2000
              icons) to Pillow's format, mode, size and pixel digest, a
              truncated file and what Pillow refuses refused (HT-marked
              Part-1 codestreams with OpenJPEG's reason); this host's Pillow / OpenJPEG versions and how many
              fixtures its decode equals (reported); cli.l3c enc / dec of
              a 9/7 JP2 and a lossless codestream bit-exact with exact
              launch counts; cli.test --write_to_files --compare_theory
              over the folder (a JP2 named .png and a codestream named
              .jpg listed), K3 to K6 launched; the host's decode MP/s of
              the 256 x 256 9/7 and 128 x 128 5/3 files, fastest of 3
 20. registry_formats
              the rest of Pillow's registry (XBM, XPM, FITS, BLP, SPIDER,
              GBR, FLI, FTEX, PIXAR, MCIDAS, IMT, IPTC, XVThumb), IM's
              YCbCr, packed, planar and numeric types and the TIFF
              variants (CCITT RLE, RLEW, Group 3 and 4, LZMA, ZSTD,
              old-style LZW and JPEG, ThunderScan, the float predictor,
              YCbCr without JPEG, CIELAB, 12-bit grey) on this machine's
              host (no Pillow): every file of
              l3c_torch/data/fixtures/registry to Pillow's format, mode,
              size and pixel digest (Pillow's default AVIF save among
              them), Pillow's refusals refused with the port's message;
              the same digests from this
              host's Pillow wherever it has the codec (held), its libtiff
              and which TIFF fixtures it reads; cli.l3c enc / dec of a
              Group 4 page and a FITS file bit-exact with exact launch
              counts;
              cli.test --write_to_files --compare_theory over the folder
              (an XPM named .png and a FITS named .jpg listed), K3 to K6
              launched; the host's decode MP/s of a 1728 x 2200 Group 4
              fax page and a 384 x 256 ZSTD RGB TIFF, fastest of 3
 21. htj2k    HTJ2K (JPEG 2000 Part 15) on this machine's host (no
              Pillow): every file of l3c_torch/data/fixtures/htj2k (HT
              code-blocks of every size, 1 to 3 passes, VSC, tiles,
              precincts, LRCP / RPCL, 8 to 16 bits, 4:2:0, RGBA, 5/3 and
              9/7, every zero bit-plane count, damaged streams) to
              Pillow's format, mode, size and pixel digest, OpenJPEG's
              refusals refused with its reason; the same digests from
              this host's Pillow wherever it imports (held), and its
              refusals (reported); cli.l3c enc / dec of a 512 x 512
              lossless codestream and a 256 x 256 9/7 JP2 bit-exact with
              exact launch counts; cli.test --write_to_files
              --compare_theory over the folder (an HT JP2 named .png
              listed), K3 to K6 launched; the host's decode MP/s of the
              two, fastest of 3
 22. avif     AVIF stills on this machine's host (no Pillow): every file
              of l3c_torch/data/fixtures/avif (AV1 lossless, lossy at
              4:4:4 / 4:2:2 / 4:2:0 / 4:0:0, full and limited range,
              BT.601 / BT.709 / identity, CfL, palettes, filter intra,
              directional, smooth and Paeth prediction, every transform
              size, tiles, 128 superblocks, delta q; the in-loop filters:
              deblocking, CDEF, Wiener and self-guided restoration,
              Pillow's default saves; film grain, quantizer matrices,
              intra block copy, premultiplied alpha; grids, frames and
              alpha scaled to ispe, the FCC, SMPTE 240, BT.2020, YCgCo,
              chroma-derived and limited identity matrices) to Pillow's
              format, mode, size and pixel digest; the same
              digests from this host's Pillow wherever it imports (held),
              its libavif, dav1d, aom and libyuv logged; cli.l3c enc /
              dec of a 512 x 512 filters-off lossy 4:2:0 file, a lossless
              4:4:4 one, a 512 x 512 default save, a 512 x 512 save
              with aom's denoiser's film grain and a 1024 x 1024 grid of
              four 512 x 512 cells bit-exact with exact launch counts;
              cli.test --write_to_files --compare_theory over the folder
              (an AVIF named .png listed), K3 to K6 launched; the host's
              decode MP/s of the five, fastest of 3, and the default,
              grain and grid saves' time by stage (the symbol walk, each
              in-loop filter, film grain, the grid's assembly); the 10-
              and 12-bit files of l3c_torch/data/fixtures/avif_deep to
              Pillow's digests or its refusals, the host Pillow's digests
              held, cli.l3c enc / dec of the 512 x 512 default save at
              10 bits, its decode MP/s beside the 8-bit save's and its
              time by stage; the image sequences of
              l3c_torch/data/fixtures/avif_seq (frame 0 of the colour
              track, with and without a meta box, flipped, refused, the
              track or the item as the brands choose) to Pillow's
              digests or its refusals, the host Pillow's digests held,
              cli.l3c enc / dec of a 512 x 512 two-frame default save and
              its decode MP/s; the files of
              l3c_torch/data/fixtures/avif_tools (superres, per-block
              loop filter deltas, segment reference features) to
              Pillow's digests or its refusals, the host Pillow's digests
              held, cli.l3c enc / dec of a 512 x 512 superres file (256
              coded wide), its decode MP/s and its time by stage (the
              upscale among them); the files of
              l3c_torch/data/fixtures/avif_hidden (frames hidden in
              dav1d's reference slots and shown by show_existing_frame,
              in stills, alpha, a grid's cells and a track; the inter
              frame after a hidden key frame refused by name; the f11_
              files, whose transforms run past valid coefficients) to
              Pillow's digests or its refusals, the host Pillow's
              digests held (the f11_ ones reported) beside the host
              CPU's AVX-512 flags, cli.l3c enc / dec of a 512 x 512
              default save hidden behind a second picture, its decode
              MP/s and its time by stage (both frames walked)
 23. report   one JSON line of kernel records (each with its path:
              serving, train or baselines, and its launches in phase cli,
              phase parallel, phase prep, phase synth, phase formats,
              phase damaged, phase pillow_formats, phase jpeg2000,
              phase registry_formats, phase htj2k and phase avif),
              the card line, then
              {"ok": true, "device": {...}} as the last line

Exits non-zero, printing no result, without CUDA or without the repo.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from l3c_torch import blueprint
from l3c_torch.cli import l3c as l3c_cli
from l3c_torch.cli import test as test_cli
from l3c_torch.codec.bitcoding2 import (TorchBitcoding, canary_inputs,
                                        canary_leaves, coder_check,
                                        contract_canary, fbatch_for,
                                        pack_int)
from l3c_torch.config import load_dl_config, load_ms_config
from l3c_torch.data.images import Testset, read_png, write_png
from l3c_torch.device import numerics_guard
from l3c_torch.eval.tester import MultiscaleTester
from l3c_torch.models import layers
from l3c_torch.models.network import MultiscaleNetwork
from l3c_torch.models.weights import load_network_weights
from l3c_torch.ops import float_cdf, gpu_coder, int_coder, kernels
from l3c_torch.ops.kernels import build
from l3c_torch.utils.logdir import find_log_dir

ROOT = os.path.dirname(os.path.abspath(__file__))
ZOO, LOG_DATE = os.path.join(ROOT, "models_zoo"), "0820_0345"
CKPT = os.path.join(ZOO, "0820_0345 cr oi_offline r@0819_0307 r5b", "ckpts",
                    "ckpt_0000246250.ckpt")
SZ, B = 512, 8                       # bench.py's serving shape
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_OPS_PER_S = 67e12               # non-tensor float32 peak

KERNEL_INFO = {
    "mixture_cdf_q": ("l3c_torch/ops/kernels/csrc/float_cdf.cu",
                      "tools/pallas_cdf.py:48"),
    "fine_cdf_q": ("l3c_torch/ops/kernels/csrc/float_cdf.cu",
                   "tools/pallas_cdf.py:120"),
    # the rANS scan and the CDF evaluation fused into its JAX program
    "rans_encode": ("l3c_torch/ops/kernels/csrc/rans.cu",
                    "l3c_tpu/ops/tpu_coder.py:305 + "
                    "l3c_tpu/codec/bitcoding2.py:320/:417"),
    "rans_decode": ("l3c_torch/ops/kernels/csrc/rans.cu",
                    "l3c_tpu/ops/tpu_coder.py:481 + "
                    "l3c_tpu/codec/bitcoding2.py:344/:361"),
    # XLA-lowered inside the JAX codec's per-scale get_P program
    "pack_int": ("l3c_torch/ops/kernels/csrc/pack.cu",
                 "l3c_tpu/ops/int_coder.py:259"),
    # the mixture NLL and its VJP, XLA-fused into the jitted train step
    "dmll_nll": ("l3c_torch/ops/kernels/csrc/dmll.cu",
                 "l3c_tpu/models/dmll.py:126"),
    "dmll_nll_grad": ("l3c_torch/ops/kernels/csrc/dmll.cu",
                      "l3c_tpu/models/dmll.py:126 (VJP, "
                      "l3c_tpu/train/trainer.py:115)"),
}
CODEC_KERNELS = ("mixture_cdf_q", "fine_cdf_q", "rans_encode", "rans_decode",
                 "pack_int")
# the int_coder row and lookup builders: on the card the main path must
# call none of them (the kernels evaluate the CDF themselves)
INT_CODER_ROWS = ("bn_rows", "bn_lookup", "rgb_coarse_rows",
                      "rgb_coarse_lookup", "rgb_fine_rows", "rgb_fine_lookup")
# the plain float pack stage and its top-k selection: none on the card
# either (K5 packs there)
PLAIN_PACK = ("pack_int_params", "pack_int_params_nchw", "topk_rank",
              "topk_index")
# f32 operations per CDF evaluation, counted from csrc/int_cdf.cuh as
# rans.cu builds it: a component's term (edge z and clip 4, the sigmoid
# table read 6: |z|, clamp, index, convert, sign and select; term and
# sum 4), an edge's finish (clamp 2 + quantize_edge 11), the fine
# conditional renormalisation (cond_norm with floor_div 29 per edge,
# cond_bounds 4 per pixel), the lambda chain per component (channel 1: 4,
# channel 2: 6). The sigmoid table (16384 int_sigmoid values of 88
# operations) is counted once per launch: the function needs each value
# once, though the kernel fills a table in every block.
OPS_TERM, OPS_EDGE, OPS_COND, OPS_BOUNDS = 14, 13, 29, 4
OPS_LAMBDA = (0, 4, 6)
OPS_TABLE = 16384 * 88
LAMBDA_SLOTS = (0, 1, 2)          # w slots read by channel c
# f32 operations of pack_int per (pixel, channel), counted from
# csrc/pack.cu: the rank (K^2 x (==, >, select, add)) and, per selected
# value, K x (compare, select) when K' < K; per component the softmax (sub,
# expf, add, div, x 4096, rint), inv_s / a_hat / m_hat / v and the three
# roundings (~16), expf and a division counted as 8 each; a lambda slot
# (sigmoid, two products, rint) ~22 per component
OPS_EXP = 8


def pack_bound(Kp: int, C: int, K: int, KS: int, lam: bool, n: int):
    """(ms, by) of one K5 launch: Kp planes of n f32 read, 4 C K' (+ 3 K'
    with the lambda slots) planes written; operations as counted above."""
    planes_out = 4 * C * KS + (3 * KS if lam else 0)
    groups = 3 + (1 if lam else 0)
    sel = (4 * K * K + groups * 2 * K * KS) if KS < K else 0
    per_comp = (4 + 2 * OPS_EXP) + (8 + 2 * OPS_EXP) + 3
    ops = C * (sel + KS * per_comp) + (3 * KS * (6 + 2 * OPS_EXP)
                                       if lam else 0)
    return bound((Kp + planes_out) * n * 4, n * ops)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() over `reps` runs, by CUDA events."""
    fn()                                              # warm-up
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def queued_ms(fn, reps: int = 20, flush=None) -> float:
    """Device milliseconds a call of fn() when `reps` calls are queued
    behind a sleeping kernel, so the host's enqueue is hidden; with
    `flush`, a flush before each call, its own time taken off."""
    def run(body):
        body()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)          # ~0.1 s of the card
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start = time.perf_counter()
        t0.record()
        for _ in range(reps):
            body()
        t1.record()
        host = time.perf_counter() - start
        torch.cuda.synchronize()
        if host > 0.09:
            raise RuntimeError(f"the host took {host * 1e3:.1f} ms to "
                               "enqueue: the card may have waited")
        return t0.elapsed_time(t1) / reps
    if flush is None:
        return run(fn)
    return run(lambda: (flush(), fn())) - run(flush)


def bound(bytes_moved: float, ops: float):
    """(ms, 'bytes'|'operations'): the larger of bytes over HBM rate and
    operations over the float32 peak."""
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def bench_images(seed=0, n=None, H=None, W=None):
    """bench.py's recipe: gradient base + noise, seed 0, the first draw
    being bench.py's single warm-up image; B images of SZ x SZ unless other
    seeds, counts and sizes are asked for (phase parallel)."""
    rng = np.random.RandomState(seed)
    n, H, W = n or B, H or SZ, W or SZ
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([yy % 256, xx % 256, (yy + xx) % 256], -1)
    draw = lambda: np.clip(base + rng.randint(-8, 8, base.shape), 0,
                           255).astype(np.uint8)[None]
    draw()
    return [draw() for _ in range(n)]


def phase_device():
    card = card_line()
    log(f"[device] {card} | torch.cuda: {torch.cuda.get_device_name(0)}"
        f" | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build()
    log(f"[device] built {list(build.SOURCES)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[device]   {name}: {line.strip()}")
    return card


def phase_forward(cfg, net, imgs, card):
    dev = next(net.parameters()).device
    with torch.inference_mode():
        x = torch.from_numpy(np.concatenate(imgs)).to(dev).float()
        t0 = time.perf_counter()
        out = net(x)
        bpsp = float(blueprint.total_bpsp(blueprint.compute_loss(cfg, out)))
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        del out
        crop = np.ascontiguousarray(imgs[0][:, :64, :64])
        b_gpu = float(blueprint.total_bpsp(blueprint.compute_loss(
            cfg, net(torch.from_numpy(crop).to(dev).float()))))
        net_cpu = MultiscaleNetwork(cfg)
        net_cpu.load_state_dict({k: v.cpu()
                                 for k, v in net.state_dict().items()})
        b_cpu = float(blueprint.total_bpsp(blueprint.compute_loss(
            cfg, net_cpu(torch.from_numpy(crop).float()))))
    rel = abs(b_gpu - b_cpu) / b_cpu
    log(f"[forward] r5b theory bpsp {bpsp:.6f} on {B}x{SZ}x{SZ} "
        f"(forward+loss {fwd_s * 1e3:.1f} ms) | 64x64 crop GPU {b_gpu:.7f} "
        f"CPU {b_cpu:.7f} rel {rel:.2e} | {card}")
    if not (math.isfinite(bpsp) and 0 < bpsp < 16):
        raise RuntimeError(f"theory bpsp {bpsp} out of range")
    if rel > 1e-4:
        raise RuntimeError(f"GPU/CPU bpsp disagree: rel {rel:.2e} > 1e-4")
    return bpsp


def count_cuda_calls(module, names, counts):
    """Wrap module.<name> to count calls whose first tensor argument lies
    on the card; returns a function that restores the originals."""
    orig = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def counted(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda or
                   isinstance(a, int_coder.IntParams) and a.p.is_cuda
                   for a in args):
                counts[name] += 1
            return fn(*args, **kw)
        return counted

    for name, fn in orig.items():
        setattr(module, name, wrap(name, fn))
    return lambda: [setattr(module, n, f) for n, f in orig.items()]


def phase_codec(bc, imgs, theory_bpsp, card):
    """The main path, launch-counted; then two more timed rounds."""
    enc_ms, dec_ms = [], []
    plain_calls = {name: 0 for name in INT_CODER_ROWS + PLAIN_PACK}
    with tempfile.TemporaryDirectory(prefix="l3c_smoke_") as d:
        warm = [os.path.join(d, f"warm{b}.l3c") for b in range(B)]
        bc.encode_batch(imgs, warm)        # cuDNN / allocator warm-up
        bc.decode_batch(warm)
        for r in range(3):
            paths = [os.path.join(d, f"r{r}_{b}.l3c") for b in range(B)]
            if r == 0:
                kernels.reset_launches()
                restore = count_cuda_calls(
                    int_coder, INT_CODER_ROWS + PLAIN_PACK,
                    plain_calls)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bpsps = bc.encode_batch(imgs, paths)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            outs = bc.decode_batch(paths, float_rows=(r == 0))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if r == 0:
                counts = dict(kernels.launches)
                restore()
            for im, o in zip(imgs, outs):
                if not np.array_equal(o, im):
                    raise RuntimeError("round trip is NOT bit-exact")
            enc_ms.append((t1 - t0) * 1e3)
            dec_ms.append((t2 - t1) * 1e3)
    missing = [k for k in CODEC_KERNELS if not counts.get(k)]
    if missing:
        raise RuntimeError(f"main path never launched {missing}: {counts}")
    # one round: unit 0 + 2 bn units + the stacked scale-0 units (encode);
    # unit 0 + 2 bn units + 3 channels x (coarse, fine) (decode); one pack
    # per scale on each side
    if (counts["rans_encode"], counts["rans_decode"],
            counts["pack_int"]) != (4, 9, 6):
        raise RuntimeError(f"expected 4 x rans_encode, 9 x rans_decode, 6 x "
                           f"pack_int per round: {counts}")
    log(f"[codec] int_coder row/lookup and plain pack/top-k calls on CUDA "
        f"tensors in the round: {plain_calls}")
    if any(plain_calls.values()):
        raise RuntimeError("the main path built CDF rows or lookups, or "
                           "packed IntParams, in PyTorch on the card")
    file_bpsp = float(np.mean(bpsps))
    mp = B * SZ * SZ / 1e6
    e, dd = statistics.median(enc_ms), statistics.median(dec_ms)
    log(f"[codec] bit-exact {B}x{SZ}x{SZ} fbatch {fbatch_for(B)} balanced "
        f"topk {bc.coder_topk} | file bpsp {file_bpsp:.6f} vs theory "
        f"{theory_bpsp:.6f} (+{100 * (file_bpsp / theory_bpsp - 1):.2f}%) |"
        f" enc {e:.1f} ms ({mp / e * 1e3:.3f} MP/s) dec {dd:.1f} ms "
        f"({mp / dd * 1e3:.3f} MP/s) enc+dec {mp / (e + dd) * 1e3:.3f} MP/s"
        f" | rounds enc {[round(t, 1) for t in enc_ms]} dec "
        f"{[round(t, 1) for t in dec_ms]} | {card}")
    log(f"[codec] main-path launches {counts}")
    # whether files written here decode on a CPU build (and the JAX
    # package): the canary attests the float pack stage rounds alike
    cpu = contract_canary(bc._rgb, bc._bn, bc.cfg.q.C, bc.cfg.prob.K,
                          bc.coder_topk, torch.device("cpu"))
    card_c = bc.canary(bc.coder_topk)
    log(f"[codec] canary topk {bc.coder_topk}: card {card_c:#010x} cpu "
        f"{cpu:#010x} ({'equal' if cpu == card_c else 'DIFFERENT'})")
    # where card and CPU part ways on the canary's inputs: the float pack
    # stage as the codec runs it (K5 on the card, the plain version on the
    # CPU; entries differing per IntParams field), and the integer
    # rows/lookups evaluated on the card from the CPU's IntParams (which
    # the exact-integer design says must be identical)
    l_rgb, l_bn, t_rgb, t_bn = canary_inputs(bc._bn, bc.cfg.q.C,
                                             bc.cfg.prob.K)
    ips = {}
    with torch.inference_mode():
        for name, spec, l, C in (("rgb", bc._rgb, l_rgb, 3),
                                 ("bn", bc._bn, l_bn, bc.cfg.q.C)):
            planes = torch.from_numpy(l).permute(0, 3, 1, 2).contiguous()
            ips[name] = [pack_int(spec, planes.to(d), C, bc.coder_topk)
                         for d in (bc.device, torch.device("cpu"))]
            diffs = {f: (int((a.cpu() != b).sum()), a.numel())
                     for f, a, b in zip(ips[name][0]._fields, *ips[name])
                     if a is not None}
            log(f"[codec] pack_int card (K5) vs cpu (plain), {name} canary "
                "inputs: " + ", ".join(f"{f} {n}/{m}"
                                       for f, (n, m) in diffs.items()))
        to_card = lambda ip: int_coder.IntParams(
            *[None if x is None else x.to(bc.device) for x in ip])
        t_r, t_b = torch.from_numpy(t_rgb), torch.from_numpy(t_bn)
        on_cpu = canary_leaves(ips["rgb"][1], ips["bn"][1], t_r, t_b,
                               bc._bn.L)
        on_card = canary_leaves(to_card(ips["rgb"][1]),
                                to_card(ips["bn"][1]), t_r.to(bc.device),
                                t_b.to(bc.device), bc._bn.L)
    n_bad = sum(int((a.cpu() != b).sum()) for (a, _), (b, _)
                in zip(on_card, on_cpu))
    log(f"[codec] integer rows/lookups from the same IntParams, card vs "
        f"cpu: {n_bad} of {sum(b.numel() for b, _ in on_cpu)} differ")
    if n_bad:
        raise RuntimeError("exact-integer evaluator differs on the card")
    # the card's canary holds K3/K4 to int_coder on the card's IntParams
    # before it is computed; here the same on the CPU's IntParams
    with torch.inference_mode():
        coder_check(to_card(ips["rgb"][1]), to_card(ips["bn"][1]), bc._bn.L)
    log("[codec] K3/K4 equal to int_coder + the plain scans on the CPU's "
        "canary IntParams at every symbol value (coder_check)")
    if not (0 < file_bpsp < 2 * theory_bpsp + 1):
        raise RuntimeError(f"file bpsp {file_bpsp} implausible")
    return counts, e + dd


def coded_units(bc, imgs, logits=None):
    """What encode_batch codes, computed as it computes it: {unit: (ip,
    true symbols (C, N), n per group)} for unit 0 ("uniform", ip None), the
    bn scales ("bn<scale>") and the RGB scales ("rgb<scale>": scale 0's
    image planes, and a baseline's downsampled images), coarse to fine.
    With a dict `logits`, the classifier's output of each scale (N, Kp, H,
    W) is left in it."""
    x = torch.from_numpy(np.concatenate(imgs)).to(bc.device)
    planes = lambda t: t.permute(3, 0, 1, 2).reshape(t.shape[3], -1)
    units = {}
    with torch.inference_mode():
        per_scale = bc.net.enc_forward(layers.sub_rgb_mean(x.float()))
        s = per_scale[-1].syms
        units["uniform"] = (None, planes(s), s.shape[1] * s.shape[2])
        dec_F, bn = None, per_scale[-1].bn_q
        for scale in reversed(range(bc.cfg.num_scales)):
            ip, dec_F, l = bc._get_P_int(scale, bc.coder_topk, bn, dec_F)
            if logits is not None:
                logits[scale] = l
            t = x if scale == 0 else per_scale[scale - 1].syms
            units[f"{'rgb' if bc._rgb_at(scale) else 'bn'}{scale}"] = (
                ip, planes(t), t.shape[1] * t.shape[2])
            if scale:
                bn = per_scale[scale - 1].bn_q
    return units


def step_counts(diff: torch.Tensor) -> Tuple[int, int, int, int]:
    """How many entries of a kernel's rows are 0, 1, 2 and more
    quantization steps off the plain version's."""
    d = diff.abs().reshape(-1)
    return tuple(int((d == n).sum()) for n in (0, 1, 2)) + (int((d > 2).sum()),)


def fine_good_rows(pi, mu, inv_s, a, bw, t0) -> torch.Tensor:
    """The well-conditioned fine rows: the coarse bin holds over 1e-2 of the
    mass (elsewhere the conditional row divides ~0 by ~0)."""
    tt = (a[:, None] * 16.0 + torch.arange(17.0, device=a.device)) * bw + t0
    cv = float_cdf.edge_cdf(pi, mu, inv_s, tt)
    return (cv[:, -1] - cv[:, 0]) > 1e-2


def float_rows_hold(label, pi, mu, inv_s, t, a, bw, t0):
    """K1 and K2 on one set of inputs against their plain versions, with
    the step counts printed. Raises unless K1 is within 1 step, K2 within 2
    on well-conditioned rows, and the finished rows strictly increasing.
    Returns (K1 rows, worst K1, worst K2 on good rows)."""
    L = t.shape[0]
    k1 = kernels.mixture_cdf_q(pi, mu, inv_s, t, L)
    k2 = kernels.fine_cdf_q(pi, mu, inv_s, a, bw, t0)
    d1 = k1 - float_cdf.mixture_cdf_q_plain(pi, mu, inv_s, t, L)
    d2 = k2 - float_cdf.fine_cdf_q_plain(pi, mu, inv_s, a, bw, t0)
    good = fine_good_rows(pi, mu, inv_s, a, bw, t0)
    err1 = int(d1.abs().max())
    err2 = int(d2[good].abs().max()) if good.any() else 0
    log(f"[kernels] {label} P={pi.shape[0]} K={pi.shape[1]}: mixture_cdf_q "
        f"L={L} entries 0/1/2/more steps off plain {step_counts(d1)} | "
        f"fine_cdf_q on {int(good.sum())} well-conditioned rows "
        f"{step_counts(d2[good])}, on all rows {step_counts(d2)}")
    if err1 > 1 or err2 > 2:
        raise RuntimeError(f"float rows off ({label}): K1 {err1} K2 {err2} "
                           "steps")
    for q in (k1, k2):
        rows = float_cdf.finish_rows(q)
        top = torch.full((rows.shape[0], 1), 65536, device=rows.device)
        if not (torch.diff(torch.cat([rows, top], 1), dim=1) >= 1).all():
            raise RuntimeError(f"float rows not strictly increasing "
                               f"({label})")
    return k1, err1, err2


# f32 operations per mixture term of K1/K2 by K5's convention (an
# exponential and a division OPS_EXP each), counted from csrc/float_cdf.cu
# (add_term / mixture): the edge's z (sub, mul), the sigmoid (negate and
# clamp 2 in K2's exact form; K1's cheap form, which has neither, is held
# to the same count; the exponential, the add of 1, the reciprocal), the
# weight's product and the sum: 2 + 2 + OPS_EXP + 1 + OPS_EXP + 2. An
# entry's finish: clip 2, the product with M, floor; K2 adds its
# conditional (sub, a true division) per entry and the 17 edge targets (3
# each) and lo / hi / denom (5) per pixel.
OPS_FLOAT_TERM = 7 + 2 * OPS_EXP
OPS_FLOAT_ENTRY = 4
OPS_FINE_ENTRY = OPS_FLOAT_ENTRY + 1 + OPS_EXP
OPS_FINE_PIXEL = 17 * 3 + 5
SFU_PER_TERM = 2                  # MUFU.EX2 and MUFU.RCP, in both kernels
SFU_PER_CLOCK_SM = 16


def phase_float_rows(bc, record):
    """K1 / K2 on the decoded scale-0 params of all three channels (the
    main path's inputs), held to the plain versions; the ragged sizes, a
    misaligned base and (K, L) = (3, 25)."""
    fr = bc.last_float_rows
    spec = bc._rgb
    bw, t0 = float_cdf._bw_t0(spec)
    err1 = err2 = 0
    for c in range(3):
        pi, mu, inv_s = float_cdf.channel_params_packed(
            spec, fr["packed"], c, fr["decoded"])
        t = float_cdf.coarse_edge_targets(spec, pi.device)
        a = (fr["decoded"][..., c].reshape(-1) / 16.0).floor()
        k1, e1, e2 = float_rows_hold(f"float rows channel {c}", pi, mu,
                                     inv_s, t, a, bw, t0)
        err1, err2 = max(err1, e1), max(err2, e2)
        # the main path's rows are these kernels' rows
        if not torch.equal(fr["rows"][c][0], float_cdf.finish_rows(k1)):
            raise RuntimeError("main-path coarse rows differ from K1")
    P, K = pi.shape
    # ragged sizes on channel 2's parameters: P no multiple of a tile, less
    # than a tile, one pixel; a base off the 16-byte boundary (rows 3..)
    for label, sl in (("ragged", slice(0, P - 77)), ("ragged", slice(0, 50)),
                      ("ragged", slice(0, 1)),
                      ("misaligned base", slice(3, 1003))):
        part = [x[sl] for x in (pi, mu, inv_s)]
        if label.startswith("mis") and not all(
                x.is_contiguous() and x.data_ptr() % 16 for x in part):
            raise RuntimeError("the slice is not misaligned")
        float_rows_hold(label, *part, t, a[sl], bw, t0)
    # K1 at the bottleneck table's shape, (K, L) = (3, 25): seeded mixtures
    rng = np.random.RandomState(25)
    p3 = [torch.from_numpy(x.astype(np.float32)).to(pi.device) for x in (
        rng.dirichlet(np.ones(3), size=5000),
        rng.uniform(-20, 280, (5000, 3)),
        np.exp(-rng.uniform(-3, 4, (5000, 3))))]
    t25 = torch.arange(25, dtype=torch.float32, device=pi.device) * 10.24 \
        - 0.5
    float_rows_hold("(K, L) = (3, 25)", *p3, t25,
                    (p3[1][:, 0] / 16.0).clamp(0, 15).floor(), bw, t0)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    run = {"mixture_cdf_q": lambda: kernels.mixture_cdf_q(
               pi, mu, inv_s, t, 16),
           "fine_cdf_q": lambda: kernels.fine_cdf_q(
               pi, mu, inv_s, a, bw, t0)}
    plain = {"mixture_cdf_q": lambda: float_cdf.mixture_cdf_q_plain(
                 pi, mu, inv_s, t, 16),
             "fine_cdf_q": lambda: float_cdf.fine_cdf_q_plain(
                 pi, mu, inv_s, a, bw, t0)}
    terms = {"mixture_cdf_q": P * 16 * K, "fine_cdf_q": P * 17 * K}
    bounds = {
        # f32 params in; rows (u16 values) out at 2 bytes
        "mixture_cdf_q": bound(3 * P * K * 4 + 16 * 4 + P * 16 * 2,
                               terms["mixture_cdf_q"] * OPS_FLOAT_TERM
                               + P * 16 * OPS_FLOAT_ENTRY),
        # coarse symbols (< 16) in at 1 byte, rows out at 2 bytes
        "fine_cdf_q": bound(3 * P * K * 4 + P + P * 16 * 2,
                            terms["fine_cdf_q"] * OPS_FLOAT_TERM
                            + P * (16 * OPS_FINE_ENTRY + OPS_FINE_PIXEL))}
    for name, err in (("mixture_cdf_q", err1), ("fine_cdf_q", err2)):
        # what this way of computing the function needs at least: its
        # special-function instructions at the unit's rate
        floor_ms = terms[name] * SFU_PER_TERM / (
            SFU_PER_CLOCK_SM * sms * mhz * 1e6) * 1e3
        log(f"[kernels] {name}: special-function floor {floor_ms * 1e3:.1f} "
            f"us = {terms[name]} sigmoids x {SFU_PER_TERM} instructions / "
            f"({SFU_PER_CLOCK_SM} a clock x {sms} SMs x {mhz:.0f} MHz, "
            "clocks.max.sm)")
        record(name, err, cuda_ms(run[name]),
               cuda_ms(plain[name]), bounds[name])
    log(f"[kernels] float rows: P={P} K={K}, 3 channels")
    bc.last_float_rows = None


def make_recorder(recs, counts, path):
    """record(name, err, ms, plain_ms, (bound ms, by), device_ms=None):
    appends the kernel's record on `path` (serving, train, baselines), with
    its launches on that path's counted run from `counts`; ms and plain_ms
    are CUDA events around one call (cuda_ms), device_ms, where measured,
    device time a launch (queued_ms)."""
    def record(name, err, ms, plain_ms, b, device_ms=None):
        src, repl = KERNEL_INFO[name]
        recs.append(dict(name=name, route="cuda", source=src, replaces=repl,
                         launches=counts[name], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                         library_ms=None, device_ms=device_ms, path=path))
        dev = "" if device_ms is None else f" (device {device_ms * 1e3:.1f})"
        log(f"[kernels] {name}: max|diff| {err} | {ms * 1e3:.1f} us/launch"
            f"{dev} | plain {plain_ms * 1e3:.1f} us | bound "
            f"{b[0] * 1e3:.1f} us ({b[1]}) | main-path launches "
            f"{counts[name]}")
    return record


def phase_kernels(bc, imgs, counts):
    recs = []
    record = make_recorder(recs, counts, "serving")
    phase_float_rows(bc, record)

    logits = {}
    phase_coder(bc, coder_cases(bc, imgs, logits), record)
    phase_pack(bc, logits, record)
    del logits
    # the layouts of phase cli, each kernel against its plain version there
    # too (the plain versions run once and are not timed):
    # cli.test --write_to_files codes the eight with the size profile (T up
    # to 16384) and all K = 10 components (K5 at topk 0 and these shapes
    # was held above: the pack does not see the stream profile) ...
    bc_size = TorchBitcoding(bc.cfg, bc.net, device=bc.device,
                             coder_profile="size")
    phase_coder(bc_size, coder_cases(bc_size, imgs), None)
    # ... and cli.l3c one image alone: fbatch 1, balanced, top-4
    one = {}
    phase_coder(bc, coder_cases(bc, imgs[:1], one), None)
    phase_pack(bc, one, None, topks=(4,))
    return recs


def pack_diffs(got, want):
    """{field: (entries differing, entries)}; raises when an entry is off
    by more than one step."""
    out = {}
    for f, g, w in zip(got._fields, got, want):
        if w is None:
            if g is not None:
                raise RuntimeError(f"pack_int: field {f} should be None")
            continue
        d = (g - w).abs()
        if not float(d.max()) <= 1:
            raise RuntimeError(f"pack_int: {f} off by {float(d.max())}")
        out[f] = (int((d > 0).sum()), d.numel())
    return out


def phase_pack(bc, logits, record, topks=(4, 0)):
    """K5 against the plain version on the round's classifier outputs at
    the three scales' shapes, topk 4 (the main path's) and topk 0 (the
    size profile's); timed only with `record`. The float part may differ after the roundings by one
    step in <= 1e-3 of the entries (the kernel's own expf and summation
    order); the selection must be exact: with mu set to the component's
    index and the log-scales to 0, v tells the selected components apart
    and must equal the plain version's bit for bit."""
    K, times, worst = bc.cfg.prob.K, {}, 0
    with torch.inference_mode():
        for scale in sorted(logits, reverse=True):
            l = logits[scale]
            spec, C = ((bc._rgb, 3) if scale == 0 else
                       (bc._bn, bc.cfg.q.C))
            N, Kp, H, W = l.shape
            for topk in topks:
                KS = topk if 0 < topk < K else K
                got = pack_int(spec, l, C, topk)
                want = int_coder.pack_int_params_nchw(spec, l, C, topk)
                diffs = pack_diffs(got, want)
                n_bad = sum(a for a, _ in diffs.values())
                n_all = sum(b for _, b in diffs.values())
                worst = max(worst, int(n_bad > 0))  # steps: 0 or 1
                if n_bad > 1e-3 * n_all:
                    raise RuntimeError(f"pack_int scale {scale} topk {topk}:"
                                       f" {n_bad}/{n_all} entries differ")
                del got, want
                shown = (f"[kernels] pack_int scale {scale} "
                         f"{tuple(l.shape)} topk {topk} (K'={KS}): differ "
                         "by one step " + ", ".join(
                             f"{f} {a}/{m}" for f, (a, m) in diffs.items()))
                if record is None:
                    log(shown + " | not timed")
                    continue
                ms = cuda_ms(lambda: pack_int(spec, l, C, topk))
                pms = cuda_ms(lambda: int_coder.pack_int_params_nchw(
                    spec, l, C, topk), 3)
                b = pack_bound(Kp, C, K, KS, spec.rgb_scale, N * H * W)
                times[scale, topk] = (ms, pms, b)
                log(shown + f" | {ms * 1e3:.1f} us/launch | plain "
                    f"{pms * 1e3:.1f} us | bound {b[0] * 1e3:.1f} us "
                    f"({b[1]})")
            if scale == 1 and record is not None:
                # why the pack divides by a tensor: by a Python scalar
                # PyTorch multiplies with the reciprocal on the card
                mu = l[:, C * K:2 * C * K]
                bw = float(np.float32(spec.bin_width))
                n_off = int((mu / bw != mu / torch.full(
                    (), bw, device=l.device)).sum())
                log(f"[kernels] scale-1 mu / bin width: tensor / Python "
                    f"scalar differs from the true division in {n_off} of "
                    f"{mu.numel()} values on the card")
                del mu
            # the selection: mu = k, log_s = 0 on the real pi logits
            lx = l.reshape(N, spec.num_params, C, K, H * W).clone()
            lx[:, 1] = torch.arange(K, dtype=l.dtype,
                                    device=l.device)[None, None, :, None]
            lx[:, 2] = 0.0
            lx = lx.reshape(l.shape)
            v_k = pack_int(spec, lx, C, 4).v
            v_p = int_coder.pack_int_params_nchw(spec, lx, C, 4).v
            same = torch.equal(v_k, v_p)
            log(f"[kernels] pack_int scale {scale}: top-4 of {K} components "
                f"selected at {v_k.numel()} entries, "
                f"{int((v_k != v_p).sum())} differ from the plain version")
            if not same:
                raise RuntimeError("pack_int selects other components than "
                                   "the plain version")
            del lx, v_k, v_p
    if record is None:
        return
    # the record: per launch, averaged over the round's launches (one per
    # scale on each codec side, topk 4)
    main = [times[scale, 4] for scale in sorted(logits)]
    n = len(main)
    log(f"[kernels] pack_int per round (2 x {n} launches): "
        f"{2 * sum(t[0] for t in main):.3f} ms | plain "
        f"{2 * sum(t[1] for t in main):.1f} ms | bound "
        f"{2 * sum(t[2][0] for t in main):.3f} ms")
    by = {k: sum(t[2][0] for t in main if t[2][1] == k)
          for k in ("bytes", "operations")}
    record("pack_int", worst, sum(t[0] for t in main) / n,
           sum(t[1] for t in main) / n,
           (sum(by.values()) / n, max(by, key=by.get)))


def coder_bound(mode, ip, n_px, words_used, c=0, L=25):
    """(ms, by) of one K3/K4 launch over n_px pixels: each IntParams field
    the mode reads at f32, symbol planes in and symbols out at 1 byte, the
    used words at 2 bytes; f32 operations per pixel from int_cdf.cuh, and
    the sigmoid table once."""
    K = 0 if ip is None else ip.p.shape[1]
    slots, lam = LAMBDA_SLOTS[c], OPS_LAMBDA[c] * K
    fields, sym_bytes, ops = {
        # mode: (IntParams fields read, symbol bytes per pixel, ops)
        "enc uniform": (0, 1, 0),
        "dec uniform": (0, 1, 0),
        "enc bn": (3, 1, 2 * (K * OPS_TERM + OPS_EDGE)),
        "dec bn": (3, 1, (L - 1) * (K * OPS_TERM + OPS_EDGE)),
        "dec rgb_coarse": (3 + slots, c + 1,
                           15 * (K * OPS_TERM + OPS_EDGE) + lam),
        "dec rgb_fine": (4 + slots, c + 2,
                         17 * K * OPS_TERM + 15 * (OPS_EDGE + OPS_COND)
                         + OPS_BOUNDS + 2 * K + lam),
        # the stacked scale-0 units: the three image planes in; per
        # channel the coarse (2 edges) and fine (4 edges) lookups from one
        # lambda chain
        "enc rgb": (12 + sum(LAMBDA_SLOTS), 3, sum(
            2 * (K * OPS_TERM + OPS_EDGE) + 4 * K * OPS_TERM
            + 2 * (OPS_EDGE + OPS_COND) + OPS_BOUNDS + 2 * K
            + OPS_LAMBDA[ch] * K for ch in range(3))),
    }[mode]
    return bound(n_px * (4 * K * fields + sym_bytes) + words_used * 2,
                 n_px * ops + (OPS_TABLE if K else 0))


class CoderCase(NamedTuple):
    """One K3/K4 launch of the round: run() calls the dispatching wrapper
    on the card, plain() the plain version on the same inputs; truth holds
    the symbols a decode must return (None for an encode)."""
    kernel: str
    label: str
    run: Callable
    plain: Callable
    truth: Optional[torch.Tensor]
    bound: Tuple[float, str]
    fbatch: int
    T: int                    # serial steps of a stream


def coder_cases(bc, imgs, logits=None) -> List[CoderCase]:
    """The K3 and K4 launches of a round of `imgs` (a float batch of its
    own) at bc's stream profile and topk, at the shapes and inputs the
    codec gives them: unit 0, the bn scales, each RGB scale's stacked units
    (encode) and each of its channels' coarse and fine symbols (decode,
    the lambda chain on the true symbols): 4 K3 and 9 K4 for cr.cf. The
    decodes read the encodes' words."""
    gc, L, F = gpu_coder, bc._bn.L, fbatch_for(len(imgs))
    if F != len(imgs):
        raise ValueError("coder_cases takes a full float batch")
    units = coded_units(bc, imgs, logits)
    t_policy = lambda n: gc.t_policy(n, bc.coder_profile)
    cases = []

    def enc(label, run, plain, mode, ip, n_px, T):
        w, ln = run()
        cases.append(CoderCase("rans_encode", label, run, plain, None,
                               coder_bound(mode, ip, n_px,
                                           int(ln.sum()) + ln.numel()), F,
                               T))
        return w, ln

    def dec(label, run, plain, truth, mode, ip, ln, T, c=0):
        cases.append(CoderCase("rans_decode", label, run, plain, truth,
                               coder_bound(mode, ip, truth.numel(),
                                           int(ln.sum()), c, L), F, T))

    with torch.inference_mode():
        # ---- unit 0: the uniform prior over all its channels (L = 256
        # for a baseline: the generic variants)
        _, syms, n = units["uniform"]
        L_u = bc._uniform_unit()[1]
        lay = gc.layout_for(n, syms.shape[0] * F, t_policy(n))
        flat = syms.reshape(-1)
        # (the lambdas bind their inputs: the names are reused below)
        w, ln = enc(f"uniform L={L_u} NS={lay.lanes} T={lay.T}",
                    lambda s=flat, y=lay: gc.encode_uniform(s, L_u, y),
                    lambda s=flat, y=lay: gc.encode_uniform_plain(s, L_u,
                                                                  y),
                    "enc uniform", None, flat.numel(), lay.T)
        wd = w[:, :int(ln.max())].contiguous()
        dec(f"uniform L={L_u} NS={lay.lanes} T={lay.T}",
            lambda w=wd, y=lay: gc.decode_uniform(w, L_u, y),
            lambda w=wd, y=lay: gc.decode_uniform_plain(w, L_u, y), syms,
            "dec uniform", None, ln, lay.T)
        # ---- the bn scales, then the RGB scales
        for key in [k for k in units if k.startswith("bn")]:
            scale = int(key[2:])
            ip, syms, n = units[key]
            lay = gc.layout_for(n, syms.shape[0] * F, t_policy(n))
            w, ln = enc(f"bn scale {scale} NS={lay.lanes} T={lay.T}",
                        lambda ip=ip, s=syms, y=lay: gc.encode_bn(ip, s, L, y),
                        lambda ip=ip, s=syms, y=lay: gc.encode_bn_plain(
                            ip, s, L, y), "enc bn", ip, syms.numel(),
                        lay.T)
            wd = w[:, :int(ln.max())].contiguous()
            dec(f"bn scale {scale} L={L} NS={lay.lanes} T={lay.T}",
                lambda ip=ip, w=wd, y=lay: gc.decode_bn(ip, w, L, y),
                lambda ip=ip, w=wd, y=lay: gc.decode_bn_plain(ip, w, L, y),
                syms, "dec bn", ip, ln, lay.T)
        # ---- an RGB scale: both units stacked (encode), per channel
        # (decode)
        for key in [k for k in units if k.startswith("rgb")]:
            rgb_cases(key, *units[key], enc, dec, t_policy, F)
    return cases


def rgb_cases(key, ip, img, n, enc, dec, t_policy, F):
    """coder_cases' launches of one RGB scale: the stacked encode of its
    coarse and fine units, then each channel's coarse and fine decode."""
    gc = gpu_coder
    T = t_policy(n)
    lay6 = gc.layout_for(n, 6 * F, T)
    w6, l6 = enc(f"{key} NS={lay6.lanes} T={T}",
                 lambda: gc.encode_rgb(ip, img, lay6),
                 lambda: gc.encode_rgb_plain(ip, img, lay6), "enc rgb",
                 ip, img.shape[1], T)
    lay = gc.layout_for(n, F, T)
    ns, half = F * lay.ns_c, lay6.lanes // 2
    planes = img.to(torch.uint8).contiguous()   # the lambda chain's
    a_true, b_true = planes >> 4, planes & 15     # decoded symbols
    for c in range(3):
        a_c = a_true[c].contiguous()
        for level, r0 in (("coarse", c * ns), ("fine", half + c * ns)):
            ln = l6[r0:r0 + ns]
            wd = w6[r0:r0 + ns, :int(ln.max())].contiguous()
            label = (f"{key} {level} c={c} L=16 NS={lay.lanes} T={T} "
                     f"W={wd.shape[1]}")
            if level == "coarse":
                dec(label,
                    lambda c=c, w=wd: gc.decode_rgb_coarse(
                        ip, c, planes, w, lay),
                    lambda c=c, w=wd: gc.decode_rgb_coarse_plain(
                        ip, c, planes, w, lay),
                    a_true[c], "dec rgb_coarse", ip, ln, T, c)
            else:
                dec(label,
                    lambda c=c, w=wd, a=a_c: gc.decode_rgb_fine(
                        ip, c, planes, a, w, lay),
                    lambda c=c, w=wd, a=a_c: gc.decode_rgb_fine_plain(
                        ip, c, planes, a, w, lay),
                    b_true[c], "dec rgb_fine", ip, ln, T, c)


def same_output(case: CoderCase, got, want) -> bool:
    """K3: lengths and the words each stream uses identical; K4: symbols
    identical (and, against the truth, the coded symbols)."""
    if case.truth is None:
        (wk, lk), (wp, lp) = got, want
        keep = lambda w, ln: w[torch.arange(w.shape[1], device=w.device)
                               [None] < ln[:, None]]
        return torch.equal(lk, lp) and torch.equal(keep(wk, lk),
                                                   keep(wp, lp))
    return torch.equal(got, want)


def phase_coder(bc, cases, record):
    """K3 and K4 in every mode at the main path's shapes and inputs,
    against their plain versions on the same inputs (exact); decodes also
    against the coded symbols. The calls are the round's launches, so
    their sums are the round's coder time. Times by CUDA events: the
    kernels a median of 5, the plain versions the comparison's one call
    (no warm-up; a median of more cost ~40 s of a run, their Python scans
    taking ~0.2-1.5 s a call). Without `record` (the layouts of phase cli)
    the plain versions are not timed. Returns [(case, ms, plain ms)]."""
    tag = (f"{bc.coder_profile} F={cases[0].fbatch} "
           f"K'={bc.coder_topk or bc.cfg.prob.K} ")
    once = []
    with torch.inference_mode():
        for case in cases:
            got = case.run()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in (0, 1))
            t0.record()
            want = case.plain()
            t1.record()
            torch.cuda.synchronize()
            once.append(t0.elapsed_time(t1))
            if not same_output(case, got, want):
                raise RuntimeError(f"{case.kernel} {case.label}: kernel != "
                                   "plain")
            if case.truth is not None and not torch.equal(
                    got.reshape(case.truth.shape).long(),
                    case.truth.long()):
                raise RuntimeError(f"{case.kernel} {case.label}: symbols "
                                   "not recovered")
        times = [(cuda_ms(c.run), one if record else float("nan"))
                 for c, one in zip(cases, once)]
    for c, (ms, pms) in zip(cases, times):
        plain = f"{pms * 1e3:.1f} us" if record else "equal, not timed"
        log(f"[kernels] {c.kernel} {tag}{c.label}: {ms * 1e3:.1f} us/launch"
            f" ({ms / c.T * 1e6:.1f} ns a step) | plain {plain} | bound "
            f"{c.bound[0] * 1e3:.1f} us ({c.bound[1]})")
    # the JSON records: per launch, averaged over the round's launches of
    # each kernel (so launches x (ms - bound) is the round's gap); bound
    # by whichever limit contributes more of the summed bound
    for name in ("rans_encode", "rans_decode"):
        ix = [i for i, c in enumerate(cases) if c.kernel == name]
        by = {k: sum(cases[i].bound[0] for i in ix
                     if cases[i].bound[1] == k)
              for k in ("bytes", "operations")}
        n = len(ix)
        log(f"[kernels] {name} {tag}per round ({n} launches): "
            f"{sum(times[i][0] for i in ix):.3f} ms | plain "
            f"{sum(times[i][1] for i in ix):.1f} ms (nan: not timed) | bound "
            f"{sum(by.values()):.3f} ms ({by['operations']:.3f} of it "
            "operations-bound)")
        if record:
            record(name, 0, sum(times[i][0] for i in ix) / n,
                   sum(times[i][1] for i in ix) / n,
                   (sum(by.values()) / n, max(by, key=by.get)))
    return [(c, ms, pms) for c, (ms, pms) in zip(cases, times)]


def np_content_hash(px: np.ndarray) -> int:
    """verify_batch's u32 content hash of a pixel buffer, with numpy."""
    flat = px.reshape(-1).astype(np.uint64)
    w = ((np.arange(flat.size, dtype=np.uint64) * np.uint64(2654435761))
         & np.uint64(0xFFFFFFFF)) | np.uint64(1)
    return int((flat * w).sum() & np.uint64(0xFFFFFFFF))


def run_cli(main, argv) -> str:
    """main(argv) in-process; its output is shown and returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    for line in buf.getvalue().splitlines():
        log(f"[cli]   {line}")
    if rc != 0:
        raise RuntimeError(f"{main.__module__} {argv} returned {rc}")
    return buf.getvalue()


# launches of one encode and one decode of a float batch (phase codec), and
# of the header canary the first time a codec object computes it: two packs
# and coder_check's two encodes and seven decodes
ENCODE = {"rans_encode": 4, "pack_int": 3}
DECODE = {"rans_decode": 9, "pack_int": 3}
CANARY = {"rans_encode": 2, "rans_decode": 7, "pack_int": 2}
# the theory bpsp of the B images (one auto-crop tile each): K6's forward
# once per scale
THEORY = {"dmll_nll": 3 * B}


def counted(total, label, fn, *parts):
    """fn() with every launch count set to 0 just before and read just
    after; raises unless the counts are exactly the sum of `parts`. The
    counts are added to `total`."""
    kernels.reset_launches()
    out = fn()
    got = {k: kernels.launches.get(k, 0) for k in kernels.KERNELS}
    want = {k: sum(p.get(k, 0) for p in parts) for k in kernels.KERNELS}
    log(f"[cli] launches of {label}: "
        f"{ {k: v for k, v in got.items() if v} }")
    if got != want:
        raise RuntimeError(f"{label}: launches {got}, expected {want}")
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    return out


def phase_cli(bc, imgs, theory_bpsp, card):
    """The serving entry points on the card, as a user calls them (no
    --device: the card is the default). Each call has its own launch
    counts, set to 0 before it and read after it, and they must be exactly
    what its path launches: a CLI call builds its codec anew, so its first
    header costs a canary."""
    total = {}
    with tempfile.TemporaryDirectory(prefix="l3c_cli_") as d:
        img_dir = os.path.join(d, "imgs")
        os.makedirs(img_dir)
        for b, im in enumerate(imgs):
            write_png(os.path.join(img_dir, f"im{b}.png"), im[0])
        src = os.path.join(img_dir, "im0.png")
        if not np.array_equal(read_png(src), imgs[0][0]):
            raise RuntimeError("PNG writer/reader do not round-trip")
        # ---- cli.l3c enc / dec of one image (balanced, top-4, fbatch 1)
        coded, back = os.path.join(d, "im0.l3c"), os.path.join(d, "back.png")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counted(total, "cli.l3c enc", lambda: run_cli(
            l3c_cli.main, [ZOO, LOG_DATE, "enc", src, coded]),
            ENCODE, CANARY)
        t1 = time.perf_counter()
        counted(total, "cli.l3c dec", lambda: run_cli(
            l3c_cli.main, [ZOO, LOG_DATE, "dec", coded, back]),
            DECODE, CANARY)
        t2 = time.perf_counter()
        if not np.array_equal(read_png(back), imgs[0][0]):
            raise RuntimeError("cli.l3c dec did not return the source PNG")
        bpsp1 = os.path.getsize(coded) * 8 / imgs[0].size
        log(f"[cli] cli.l3c enc+dec of one {SZ}x{SZ} PNG bit-exact: file "
            f"bpsp {bpsp1:.6f} | enc {1e3 * (t1 - t0):.0f} ms dec "
            f"{1e3 * (t2 - t1):.0f} ms, each with the checkpoint load, the "
            f"canary and cuDNN's first calls | {card}")
        # ---- cli.test: theory bpsp of the eight (no file is written)
        out = counted(total, "cli.test", lambda: run_cli(
            test_cli.main, [ZOO, LOG_DATE, img_dir, "--reset_cache"]),
            THEORY)
        shown = float(out.strip().splitlines()[-1].split()[-1])
        tester = MultiscaleTester.from_log_dir(
            find_log_dir(ZOO, LOG_DATE), l3c_cli.default_config_roots(),
            use_cache=False)
        res = tester.test(Testset(img_dir))
        rel = abs(res.mean_bpsp() - theory_bpsp) / theory_bpsp
        log(f"[cli] cli.test theory bpsp {res.mean_bpsp():.6f} (table "
            f"{shown:.4f}) vs phase forward {theory_bpsp:.6f}: rel "
            f"{rel:.2e}")
        if rel > 1e-5 or f"{res.mean_bpsp():.4f}" != f"{shown:.4f}":
            raise RuntimeError("cli.test bpsp differs from phase forward's")
        # ---- cli.test of one 509x383 image (padded for the pyramid): 3
        # x K6 forward, each launch held to the plain version on its inputs
        odd_dir = os.path.join(d, "odd")
        os.makedirs(odd_dir)
        write_png(os.path.join(odd_dir, "odd.png"),
                  np.ascontiguousarray(imgs[1][0, :509, :383]))
        seen = []

        def capture(orig):
            def run(l, x, lam, *consts):
                nll = orig(l, x, lam, *consts)
                seen.append((l, x, lam, nll))
                return nll
            return run

        with patched(kernels, "dmll_nll", capture):
            out = counted(total, "cli.test 509x383", lambda: run_cli(
                test_cli.main, [ZOO, LOG_DATE, odd_dir, "--reset_cache"]),
                {"dmll_nll": 3})
        odd_bpsp = float(out.strip().splitlines()[-1].split()[-1])
        from l3c_torch.models import dmll
        for l, x, lam, nll in seen:
            spec = (blueprint.rgb_spec(bc.cfg) if lam
                    else blueprint.bn_spec(bc.cfg))
            want = dmll.nll_plain(spec, x, l.permute(0, 2, 3, 1))
            stats, _ = k6_agree(f"cli.test {tuple(l.shape)}", (nll,),
                                (want,))
            log(f"[cli] cli.test 509x383: K6 on l {tuple(l.shape)} vs "
                f"plain: {stats}")
        if not (math.isfinite(odd_bpsp) and 0 < odd_bpsp < 16):
            raise RuntimeError(f"cli.test 509x383 bpsp {odd_bpsp}")
        log(f"[cli] cli.test of one 509x383 PNG: theory bpsp {odd_bpsp:.4f}")
        # ---- cli.test --write_to_files --compare_theory: size profile,
        # all K components, the eight as one group, bit-exact gate inside
        out_dir, rep = os.path.join(d, "out"), os.path.join(d, "times.txt")
        out = counted(
            total, "cli.test --write_to_files", lambda: run_cli(
                test_cli.main, [
                    ZOO, LOG_DATE, img_dir, "--write_to_files", out_dir,
                    "--compare_theory", "--time_report", rep,
                    "--reset_cache"]), ENCODE, DECODE, CANARY, THEORY)
        sizes = [os.path.getsize(os.path.join(out_dir, f"im{b}.l3c"))
                 for b in range(B)]
        head = open(os.path.join(out_dir, "im0.l3c"), "rb").read(8)
        if (head[6], head[7]) != (fbatch_for(B), 0):
            raise RuntimeError(f"expected fbatch {fbatch_for(B)}, topk 0 in "
                               f"the header: {head[6]}, {head[7]}")
        size_bpsp = float(np.mean(sizes)) * 8 / imgs[0].size
        shown = float(out.strip().splitlines()[-1].split()[-1])
        if f"{size_bpsp:.4f}" != f"{shown:.4f}" or \
                out.count("assumed:") != B:
            raise RuntimeError("cli.test --write_to_files table does not "
                               "show the files' bpsp")
        times = {}
        for line in open(rep).read().splitlines():
            key, val = line.strip().rsplit(": ", 1)
            times[key] = float(val[:-2])
        log(f"[cli] cli.test --write_to_files: {B} files bit-exact, size "
            f"profile (T up to 16384), K'={bc.cfg.prob.K}, fbatch "
            f"{head[6]}: file bpsp {size_bpsp:.6f} vs theory "
            f"{res.mean_bpsp():.6f} "
            f"(+{100 * (size_bpsp / res.mean_bpsp() - 1):.2f}%) | enc "
            f"{times['enc']:.1f} ms dec {times['dec']:.1f} ms (one group, "
            f"its first: warm-up included) | {card}")
        # ---- the staged round: pixels cross to the card once, the decoded
        # batch stays there, two scalars come back
        paths = [os.path.join(d, f"s{b}.l3c") for b in range(B)]

        def staged_round():
            staged = bc.stage_batch(imgs)
            bpsps = bc.encode_batch(None, paths, staged=staged)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            handle = bc.decode_batch_async(paths)
            return (bpsps, t1, handle, *bc.verify_batch(handle, staged))

        # bc has its canary since phase codec
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bpsps, t1, handle, ok, h = counted(total, "the staged round",
                                           staged_round, ENCODE, DECODE)
        t2 = time.perf_counter()
        want = np_content_hash(np.concatenate(imgs))
        log(f"[cli] staged round: verify_batch flag {ok}, hash {h:#010x} "
            f"(numpy {want:#010x}) | file bpsp {np.mean(bpsps):.6f} | "
            f"stage+enc {1e3 * (t1 - t0):.1f} ms dec+verify "
            f"{1e3 * (t2 - t1):.1f} ms | {card}")
        if not ok or h != want:
            raise RuntimeError("staged round: decoded batch differs from "
                               "the staged pixels")
        if not handle["imgs"].is_cuda:
            raise RuntimeError("staged round: the decoded batch left the "
                               "card")
    log(f"[cli] launches on this path, all calls: {total}")
    return total


def phase_profile(bc, imgs, round_ms):
    """Device time by op and kernel over one encode+decode round
    (torch.profiler); busy share against the unprofiled round's wall time
    `round_ms` (profiling itself slows the host side many times over)."""
    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory(prefix="l3c_prof_") as d:
        paths = [os.path.join(d, f"p{b}.l3c") for b in range(B)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bc.encode_batch(imgs, paths)
            bc.decode_batch(paths)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if getattr(e, "self_device_time_total", 0) > 0]
    # kernels are device-type events; host ops carry their kernels' time
    # again as self device time, so sum only the former
    kern = [e for e in ev if str(e.device_type).endswith("CUDA")]
    ops = [e for e in ev if not str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    log(f"[profile] enc+dec round: device busy {busy:.1f} ms in "
        f"{sum(e.count for e in kern)} kernel launches = "
        f"{100 * busy / round_ms:.1f}% of the unprofiled round's "
        f"{round_ms:.1f} ms wall (profiled wall {wall:.1f} ms)")
    for title, group in (("op", ops), ("kernel", kern)):
        group.sort(key=lambda e: -e.self_device_time_total)
        for e in group[:15]:
            log(f"[profile] {title:6s} {e.self_device_time_total / 1e3:9.2f}"
                f" ms {e.count:6d}x  {e.key[:80]}")


# ------------------------------------------------------------------ serve

# bench.py's serving configuration: its three shapes (phase-split
# :236-266, duplex :215-235, device-resident duplex with the on-device
# verification :193-214), each in float32 and in bfloat16 (bench.py:35-37
# serves with compute_dtype bfloat16): SERVE_ROUNDS timed rounds after
# one warm-up round, SERVE_DEPTH batches in flight
SERVE_ROUNDS, SERVE_DEPTH = 4, 2
SERVE_SHAPES = ("phase-split", "duplex", "resident")


def with_dtype(cfg, net, dtype):
    """(cfg, a copy of net on the card) computing in `dtype`, with the
    same float32 parameters."""
    c = dataclasses.replace(cfg, compute_dtype=dtype)
    n = MultiscaleNetwork(c)
    n.load_state_dict(net.state_dict())
    return c, n.cuda().eval()


def pipeline(disp, fin, n: int) -> List[float]:
    """bench.py's duplex loop at depth SERVE_DEPTH: n dispatches, every
    round dispatching one and finishing the oldest in flight. Returns the
    ms of the rounds that began with a dispatch, the first (the warm-up)
    left out; the drain is not timed."""
    inflight = [disp(i) for i in range(SERVE_DEPTH - 1)]
    rounds = []
    for i in range(SERVE_DEPTH - 1, n + SERVE_DEPTH - 1):
        t0 = time.perf_counter()
        if i < n:
            inflight.append(disp(i))
        fin(inflight.pop(0))
        if i < n:
            rounds.append((time.perf_counter() - t0) * 1e3)
    return rounds[1:]


def device_busy_split_ms(fn) -> Tuple[float, float]:
    """(kernel ms, copy ms) on the device while fn() runs
    (torch.profiler): the v1 codec's copies to the host are device time
    that no kernel spends."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if getattr(e, "self_device_time_total", 0) > 0
          and str(e.device_type).endswith("CUDA")]
    copy = lambda e: e.key.startswith(("Memcpy", "Memset"))
    return (sum(e.self_device_time_total for e in ev if not copy(e)) / 1e3,
            sum(e.self_device_time_total for e in ev if copy(e)) / 1e3)


def device_busy_ms(fn) -> float:
    """Device time of what fn() runs on the card (torch.profiler), ms."""
    return sum(device_busy_split_ms(fn))


def serve_shape(bc, shape, imgs, d, warm, ref):
    """One serving shape at full size: (MP/s, median round ms, the rounds'
    ms, launches a round, device-busy ms a round). Every decoded batch
    must equal the images and every encoded file encode_batch's bytes
    `ref`; the round's launches must be exactly an encode's and a
    decode's."""
    n = SERVE_ROUNDS + 2
    dt = bc.cfg.compute_dtype
    paths = lambda tag, i: [os.path.join(d, f"{dt}_{shape}{tag}{i}_{b}.l3c")
                            for b in range(B)]

    def files_equal(ps):
        for p, want in zip(ps, ref):
            with open(p, "rb") as f:
                if f.read() != want:
                    raise RuntimeError(f"serve {shape}: the encode pair's "
                                       f"{p} differs from encode_batch's")

    def pixels_equal(outs):
        for o, im in zip(outs, imgs):
            if not np.array_equal(o, im):
                raise RuntimeError(f"serve {shape}: round NOT bit-exact")

    staged = bc.stage_batch(imgs) if shape == "resident" else None
    want_hash = np_content_hash(np.concatenate(imgs)) if staged else None

    def verified(vh):
        ok, h = bc.verify_batch_finish(vh)
        if not ok or h != want_hash:
            raise RuntimeError(f"serve {shape}: on-device verification "
                               f"failed (flag {ok}, hash {h:#010x})")

    if shape == "phase-split":
        def enc_disp(i):
            return bc.encode_batch_async(imgs, paths("e", i)), paths("e", i)

        def enc_fin(h):
            bc.encode_batch_finish(h[0])
            files_equal(h[1])

        def dec_fin(h):
            pixels_equal(bc.decode_batch_finish(h))

        kernels.reset_launches()
        enc = pipeline(enc_disp, enc_fin, n)
        dec = pipeline(lambda i: bc.decode_batch_async(paths("e", i)),
                       dec_fin, n)
        launches = dict(kernels.launches)
        med = statistics.median(enc) + statistics.median(dec)
        rounds = [a + b for a, b in zip(enc, dec)]
        busy = device_busy_ms(lambda: (
            enc_fin(enc_disp(n)), dec_fin(bc.decode_batch_async(warm))))
    else:
        def disp(i):
            e = bc.encode_batch_async(None if staged else imgs,
                                      paths("d", i), staged=staged)
            return e, bc.decode_batch_async(warm), paths("d", i)

        def fin(h):
            bc.encode_batch_finish(h[0])
            files_equal(h[2])
            if staged is None:
                pixels_equal(bc.decode_batch_finish(h[1]))
            else:
                verified(bc.verify_batch_async(h[1], staged))

        kernels.reset_launches()
        rounds = pipeline(disp, fin, n)
        launches = dict(kernels.launches)
        med = statistics.median(rounds)
        busy = device_busy_ms(lambda: fin(disp(n)))
    per_round = {k: v / n for k, v in launches.items() if v}
    want = {k: ENCODE.get(k, 0) + DECODE.get(k, 0) for k in kernels.KERNELS}
    if {k: launches.get(k, 0) for k in kernels.KERNELS} != {
            k: v * n for k, v in want.items()}:
        raise RuntimeError(f"serve {shape}: {n} rounds launched "
                           f"{launches}, expected {want} a round")
    return B * SZ * SZ / 1e6 / med * 1e3, med, rounds, per_round, busy


def phase_serve(cfg, net, imgs, card):
    """bench.py's serving configuration on the card, in float32 and in
    bfloat16 (the same r5b parameters): theory and file bpsp of the 8
    images, a bit-exact round at fbatch 8 and at fbatch 1 through the
    synchronous calls, then the three shapes through the async pairs,
    each round bit-exact, its files byte-identical to encode_batch's and
    its launches exactly an encode's and a decode's."""
    mp = B * SZ * SZ / 1e6
    res = {}
    with tempfile.TemporaryDirectory(prefix="l3c_serve_") as d:
        for dtype in ("float32", "bfloat16"):
            cfg_d, net_d = ((cfg, net) if dtype == "float32" else
                            with_dtype(cfg, net, dtype))
            bc = TorchBitcoding(cfg_d, net_d, device="cuda",
                                coder_profile="balanced", coder_topk=4)
            with torch.inference_mode():
                theory = float(blueprint.total_bpsp(blueprint.compute_loss(
                    cfg_d, net_d(torch.from_numpy(np.concatenate(imgs))
                                 .cuda().float()))))
            warm = [os.path.join(d, f"{dtype}_w{b}.l3c") for b in range(B)]
            file_bpsp = float(np.mean(bc.encode_batch(imgs, warm)))
            ref = []
            for p in warm:
                with open(p, "rb") as f:
                    ref.append(f.read())
            outs = bc.decode_batch(warm)
            one = [os.path.join(d, f"{dtype}_one.l3c")]
            bc.encode_batch(imgs[:1], one)
            outs += bc.decode_batch(one)
            for o, im in zip(outs, imgs + imgs[:1]):
                if not np.array_equal(o, im):
                    raise RuntimeError(f"serve {dtype}: encode_batch / "
                                       "decode_batch NOT bit-exact")
            log(f"[serve] {dtype}: theory bpsp {theory:.6f}, file bpsp "
                f"{file_bpsp:.6f} on {B}x{SZ}x{SZ}; bit-exact at fbatch 8 "
                f"and at fbatch 1 | {card}")
            res[dtype] = dict(theory=theory, file=file_bpsp)
            for shape in SERVE_SHAPES:
                mps, med, rounds, per_round, busy = serve_shape(
                    bc, shape, imgs, d, warm, ref)
                res[dtype][shape] = mps
                log(f"[serve] {dtype} {shape}: {mps:.3f} MP/s ({mp:.3f} MP "
                    f"a round), median round {med:.1f} ms of "
                    f"{[round(r, 1) for r in rounds]} (depth {SERVE_DEPTH}, "
                    f"{SERVE_ROUNDS} after a warm-up), device busy "
                    f"{busy:.1f} ms a round = {100 * busy / med:.1f}%, "
                    f"launches a round {per_round} | {card}")
            del bc, net_d
    f32, bf = res["float32"], res["bfloat16"]
    log(f"[serve] bfloat16 vs float32 on the same {B} images: theory bpsp "
        f"{bf['theory']:.6f} vs {f32['theory']:.6f} "
        f"({100 * (bf['theory'] / f32['theory'] - 1):+.3f}%), file bpsp "
        f"{bf['file']:.6f} vs {f32['file']:.6f} "
        f"({100 * (bf['file'] / f32['file'] - 1):+.3f}%); MP/s "
        + ", ".join(f"{s} {bf[s]:.3f} vs {f32[s]:.3f}"
                    for s in SERVE_SHAPES) + f" | {card}")
    return res


# ----------------------------------------------------------------- limits

# the sizes the JAX package takes where the kernels' fast variants stop:
# K6 at q.C = 9 and 16 (channel groups of 8), every kernel at K = 12 and
# 16 (the generic variants), K1 and K3/K4 at L = 40
LIMIT_K6 = ((False, 10, 9), (False, 4, 16), (True, 12, 3), (False, 16, 5),
            (True, 16, 3))
LIMIT_SIDE, LIMIT_N = 64, 2


def limit_line(label, ms, plain_ms, b, T=None):
    """A [limits] line; a coder launch's also with its serial steps T (a
    stream's symbols) and its time a step."""
    steps = "" if T is None else f" | T={T}: {ms / T * 1e6:.1f} ns a step"
    log(f"[limits] {label}: {ms * 1e3:.1f} us/launch{steps} | plain "
        f"{plain_ms * 1e3:.1f} us | bound {b[0] * 1e3:.2f} us ({b[1]})")


def coder_variant(kernel, mode, K, L):
    """'generic' or 'tiled': the variant rans.cu's launcher runs (generic
    past the tiles' K' <= 10 components, and for K4's uniform and bn modes
    past their 33 symbols)."""
    past = K > 10 or (kernel == "rans_decode" and mode in ("uniform", "bn")
                      and L > 33)
    return "generic" if past else "tiled"


def phase_limits(cfg, card, imgs, dev="cuda"):
    """Every kernel where the JAX package's sizes pass its fast variant,
    at LIMIT_N x LIMIT_SIDE^2 pixels, against its plain version on the
    card at the bound the kernel is held to on the main path; each timed
    (CUDA events around one call) beside its plain version and bound; then
    a full-width model past the tiles (limits_full_width)."""
    from l3c_torch.models import dmll
    n_px = LIMIT_N * LIMIT_SIDE ** 2
    # ---- K6: channel groups and the generic variant
    for rgb, K, C in LIMIT_K6:
        spec = (blueprint.rgb_spec(cfg) if rgb else blueprint.bn_spec(cfg))
        x, l_nchw, g = k6_inputs(rgb, K, C, LIMIT_N, LIMIT_SIDE, LIMIT_SIDE,
                                 K + C)
        kernels.reset_launches()
        got = k6_grads(dmll.nll, spec, x, l_nchw, g)
        if dict(kernels.launches) != {"dmll_nll": 1, "dmll_nll_grad": 1}:
            raise RuntimeError(f"K6 launches {dict(kernels.launches)}")
        want = k6_grads(dmll.nll_plain, spec, x, l_nchw, g)
        label = f"K6 {'RGB' if rgb else 'bn'} K={K} C={C}"
        stats, _ = k6_agree(label, got, want)
        log(f"[limits] {label} vs plain: {stats}")
        lv = l_nchw.permute(0, 2, 3, 1)
        fwd = lambda f: f(spec, x, lv)
        limit_line(f"{label} dmll_nll", cuda_ms(lambda: fwd(dmll.nll)),
                   cuda_ms(lambda: fwd(dmll.nll_plain), 3),
                   k6_bound(l_nchw, x, spec, False))
        half, lo, up = (spec.bin_width / 2, spec.x_lower_bound,
                        spec.x_upper_bound)
        limit_line(f"{label} dmll_nll_grad", cuda_ms(
            lambda: kernels.dmll_nll_grad(l_nchw, x, g, rgb, half, lo, up)),
            cuda_ms(lambda: k6_grads(dmll.nll_plain, spec, x, l_nchw, g), 3)
            - cuda_ms(lambda: fwd(dmll.nll_plain), 3),
            k6_bound(l_nchw, x, spec, True))
    # ---- K5 generic, then K3/K4 on its IntParams
    gc = gpu_coder
    for K in (12, 16):
        for rgb in (True, False):
            L = 25 if K == 12 else 40
            spec = (blueprint.rgb_spec(cfg) if rgb else
                    dmll.DMLLSpec(False, -1.0, 1.0, L))
            C = 3 if rgb else cfg.q.C
            rng = np.random.RandomState(K + rgb)
            l = torch.from_numpy((rng.randn(
                LIMIT_N, spec.num_params * C * K, LIMIT_SIDE, LIMIT_SIDE)
                * 2.0).astype(np.float32)).to(dev)
            for topk in (4, 0):
                KS = topk or K
                got = pack_int(spec, l, C, topk)
                diffs = pack_diffs(got, int_coder.pack_int_params_nchw(
                    spec, l, C, topk))
                n_bad = sum(a for a, _ in diffs.values())
                n_all = sum(b for _, b in diffs.values())
                label = f"K5 {'RGB' if rgb else 'bn'} K={K} topk {topk}"
                log(f"[limits] {label} vs plain: {n_bad}/{n_all} entries "
                    "one step off")
                if n_bad > 1e-3 * n_all:
                    raise RuntimeError(f"{label}: too many entries differ")
                limit_line(label, cuda_ms(lambda: pack_int(spec, l, C, topk)),
                           cuda_ms(lambda: int_coder.pack_int_params_nchw(
                               spec, l, C, topk), 3),
                           pack_bound(l.shape[1], C, K, KS, rgb, n_px))
            ip = pack_int(spec, l, C, 0)        # K' = K: the generic coder
            coder_limits(f"K={K}", ip, rgb, C, L, dev)
    # ---- K3/K4 at L = 40 with K' <= 10 (the tiles' registers, the generic
    # row length), and the uniform unit at L = 40
    spec40 = dmll.DMLLSpec(False, -1.0, 1.0, 40)
    rng = np.random.RandomState(40)
    l = torch.from_numpy((rng.randn(LIMIT_N, 3 * cfg.q.C * 10, LIMIT_SIDE,
                                    LIMIT_SIDE) * 2.0).astype(np.float32)
                         ).to(dev)
    coder_limits("K'=4", pack_int(spec40, l, cfg.q.C, 4), False,
                 cfg.q.C, 40, dev)
    syms = torch.from_numpy(rng.randint(0, 40, (cfg.q.C * n_px,))).to(dev)
    lay = gc.layout_for(n_px, cfg.q.C, 256)
    coder_pair("uniform L=40", lambda: gc.encode_uniform(syms, 40, lay),
               lambda: gc.encode_uniform_plain(syms, 40, lay),
               lambda w: gc.decode_uniform(w, 40, lay),
               lambda w: gc.decode_uniform_plain(w, 40, lay),
               syms.reshape(cfg.q.C, -1), ("enc uniform", "dec uniform"),
               None, n_px * cfg.q.C, 40, lay.T)
    # ---- K1 / K2 at K = 12 and 16, K1 at L = 40
    bw, t0 = float_cdf._bw_t0(blueprint.rgb_spec(cfg))
    for K, L in ((12, 16), (16, 16), (10, 40), (16, 40)):
        rng = np.random.RandomState(K * L)
        P = n_px
        p3 = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
            rng.dirichlet(np.ones(K), size=P), rng.uniform(-20, 280, (P, K)),
            np.exp(-rng.uniform(-3, 4, (P, K))))]
        t = torch.arange(L, dtype=torch.float32, device=dev) * (
            256.0 / L) - 0.5
        a = (p3[1][:, 0] / 16.0).clamp(0, 15).floor()
        float_rows_hold(f"limits K={K} L={L}", *p3, t, a, bw, t0)
        limit_line(f"K1 K={K} L={L}", cuda_ms(
            lambda: kernels.mixture_cdf_q(*p3, t, L)), cuda_ms(
            lambda: float_cdf.mixture_cdf_q_plain(*p3, t, L), 3),
            bound(3 * P * K * 4 + L * 4 + P * L * 2,
                  P * L * K * OPS_FLOAT_TERM + P * L * OPS_FLOAT_ENTRY))
        if L == 16:
            limit_line(f"K2 K={K}", cuda_ms(
                lambda: kernels.fine_cdf_q(*p3, a, bw, t0)), cuda_ms(
                lambda: float_cdf.fine_cdf_q_plain(*p3, a, bw, t0), 3),
                bound(3 * P * K * 4 + P + P * 16 * 2,
                      P * 17 * K * OPS_FLOAT_TERM
                      + P * (16 * OPS_FINE_ENTRY + OPS_FINE_PIXEL)))
    log(f"[limits] every kernel at q.C = 9 / 16, K = 12 / 16 and L = 40 "
        f"held to its plain version | {card}")
    limits_full_width(cfg, imgs, card, dev)


# the full-width model past the tiles: cr.cf with K = 16 mixture components
# (the JAX package takes up to 255), fresh weights from this seed
LIMIT_FULL_K, LIMIT_FULL_SEED = 16, 0


def rans_params(fn: str) -> List[str]:
    """The parameter names of launcher `fn` of csrc/rans.cu."""
    with open(os.path.join(build.CSRC, "rans.cu")) as f:
        found = dict(build._EXTERN.findall(f.read()))
    return [p.replace("*", " ").split()[-1] for p in found[fn].split(",")]


@contextlib.contextmanager
def coder_args(seen: list):
    """While open, every K3/K4 launch appends (kernel, mode, K', L, T,
    lanes), as the wrappers pass them to the launchers."""
    names = {fn: rans_params(fn) for fn in ("l3c_rans_encode",
                                            "l3c_rans_decode")}
    modes = {"l3c_rans_encode": {v: k for k, v in kernels.ENC_MODES.items()},
             "l3c_rans_decode": {v: k for k, v in kernels.DEC_MODES.items()}}
    orig = build.call

    def call(lib, fn, *args):
        if fn in names:
            a = dict(zip(names[fn], args))
            seen.append((fn[4:], modes[fn][a["mode"]], a["K"], a["L"],
                         a["T"], a["lanes"]))
        return orig(lib, fn, *args)

    build.call = call
    try:
        yield
    finally:
        build.call = orig


def coder_line(tag, case, ms):
    """Log a K3/K4 case held to its plain version with its time, its
    variant (read from the launcher's arguments of one more run), T and
    its time a step."""
    one = []
    with coder_args(one):
        case.run()
    (k, m, K, L, T, _), = one
    log(f"{tag} {k} {coder_variant(k, m, K, L)} {case.label}: "
        f"{ms * 1e3:.1f} us/launch | T={T}: {ms / T * 1e6:.1f} ns a step | "
        f"equal to the plain version | bound {case.bound[0] * 1e3:.2f} us "
        f"({case.bound[1]})")


def limits_full_width(cfg, imgs, card, dev="cuda"):
    """cr.cf at full width with K = LIMIT_FULL_K components, fresh weights
    (seed LIMIT_FULL_SEED), on the B images of bench.py's recipe: one
    TorchBitcoding round at the size profile (top-k 0, so every bn and RGB
    unit has K' = 16, as cli.test --write_to_files codes): every pixel
    round-trips, the round launches exactly an encode's and a decode's
    kernels and every bn and RGB K3/K4 launch runs the generic variant;
    then each K3/K4 launch of the round held to its plain version and
    timed, with its variant, NS and T."""
    t_start = time.perf_counter()
    cfg_k = dataclasses.replace(cfg, prob=dataclasses.replace(
        cfg.prob, K=LIMIT_FULL_K))
    torch.manual_seed(LIMIT_FULL_SEED)
    net = MultiscaleNetwork(cfg_k).to(dev).eval()
    bc = TorchBitcoding(cfg_k, net, device=dev, coder_profile="size")
    label = f"cr.cf K={LIMIT_FULL_K} fresh, size"
    seen = []
    with tempfile.TemporaryDirectory(prefix="l3c_limits_") as d:
        bc.encode_batch(imgs, [os.path.join(d, f"w{b}.l3c")
                               for b in range(len(imgs))])   # the canary
        paths = [os.path.join(d, f"r{b}.l3c") for b in range(len(imgs))]
        with coder_args(seen):
            outs = counted({}, f"{label} round", lambda: (
                bc.encode_batch(imgs, paths), bc.decode_batch(paths))[1],
                ENCODE, DECODE)
    if not all(np.array_equal(o, im) for o, im in zip(outs, imgs)):
        raise RuntimeError(f"{label}: the round trip is NOT bit-exact")
    variants = [(k, m, coder_variant(k, m, K, L)) for k, m, K, L, _, _ in
                seen]
    log(f"[limits] {label}: {len(imgs)} x {imgs[0].shape[1]} x "
        f"{imgs[0].shape[2]} bit-exact; K3/K4 launches (kernel, mode, K', "
        f"L, T, NS): {seen}")
    off = [v for v in variants if v[1] != "uniform" and v[2] != "generic"]
    if off or len(variants) != ENCODE["rans_encode"] + DECODE["rans_decode"]:
        raise RuntimeError(f"{label}: bn and RGB launches not all generic: "
                           f"{variants}")
    for c, ms, _ in phase_coder(bc, coder_cases(bc, imgs), None):
        coder_line(f"[limits] {label}", c, ms)
    log(f"[limits] {label}: every bn and RGB launch generic, held to its "
        f"plain version ({time.perf_counter() - t_start:.1f} s) | {card}")


def coder_pair(label, enc, enc_plain, dec, dec_plain, truth, modes, ip,
               n_sym, L, T, c=0):
    """One K3 encode and its K4 decode against their plain versions:
    lengths and used words identical, symbols identical and equal to the
    coded ones; both timed, with their variant and T."""
    (w, ln), (wp, lp) = enc(), enc_plain()
    used = lambda w_, l_: w_[torch.arange(w_.shape[1], device=w_.device)[
        None] < l_[:, None]]
    if not (torch.equal(ln, lp) and torch.equal(used(w, ln), used(wp, lp))):
        raise RuntimeError(f"K3 {label} differs from its plain version")
    words = w[:, :int(ln.max())].contiguous()
    got, want = dec(words), dec_plain(words)
    if not torch.equal(got, want) or not torch.equal(
            got.reshape(truth.shape).long(), truth.long()):
        raise RuntimeError(f"K4 {label}: symbols differ or do not round-trip")
    n_words = int(ln.sum())
    K = 0 if ip is None else ip.p.shape[1]
    mode = modes[0].split()[1]
    ns = f"NS={ln.numel()}"
    limit_line(f"K3 {coder_variant('rans_encode', mode, K, L)} {label} {ns}",
               cuda_ms(enc), cuda_ms(enc_plain, 1),
               coder_bound(modes[0], ip, n_sym, n_words, c, L), T)
    limit_line(f"K4 {coder_variant('rans_decode', mode, K, L)} {label} {ns}",
               cuda_ms(lambda: dec(words)),
               cuda_ms(lambda: dec_plain(words), 1),
               coder_bound(modes[1], ip, n_sym, n_words, c, L), T)
    log(f"[limits] K3/K4 {label}: words, lengths and symbols equal to the "
        "plain versions', round trip exact")


def coder_limits(tag, ip, rgb, C, L, dev):
    """K3/K4 on IntParams `ip` (C, K', N): the bn unit at L symbols, or
    the stacked RGB units and every channel's coarse and fine decode."""
    gc = gpu_coder
    N = ip.p.shape[2]
    rng = np.random.RandomState(N + C)
    if not rgb:
        syms = torch.from_numpy(rng.randint(0, L, (C, N))).to(dev)
        lay = gc.layout_for(N, C, 256)
        coder_pair(f"bn {tag} L={L}",
                   lambda: gc.encode_bn(ip, syms, L, lay),
                   lambda: gc.encode_bn_plain(ip, syms, L, lay),
                   lambda w: gc.decode_bn(ip, w, L, lay),
                   lambda w: gc.decode_bn_plain(ip, w, L, lay), syms,
                   ("enc bn", "dec bn"), ip, N * C, L, lay.T)
        return
    img = torch.from_numpy(rng.randint(0, 256, (3, N))).to(dev)
    lay6, lay = gc.layout_for(N, 6, 256), gc.layout_for(N, 1, 256)
    w6, l6 = gc.encode_rgb(ip, img, lay6)
    wp, lp = gc.encode_rgb_plain(ip, img, lay6)
    used = lambda w_, l_: w_[torch.arange(w_.shape[1], device=w_.device)[
        None] < l_[:, None]]
    if not (torch.equal(l6, lp) and torch.equal(used(w6, l6),
                                                used(wp, lp))):
        raise RuntimeError(f"K3 RGB {tag} differs from its plain version")
    K = ip.p.shape[1]
    limit_line(f"K3 {coder_variant('rans_encode', 'rgb', K, 16)} RGB {tag} "
               f"NS={lay6.lanes}",
               cuda_ms(lambda: gc.encode_rgb(ip, img, lay6)),
               cuda_ms(lambda: gc.encode_rgb_plain(ip, img, lay6), 1),
               coder_bound("enc rgb", ip, N, int(l6.sum())), lay6.T)
    ns, half = lay.ns_c, lay6.lanes // 2
    dec = torch.zeros((3, N), dtype=torch.uint8, device=dev)
    for c in range(3):
        wc = w6[c * ns:(c + 1) * ns]
        wf = w6[half + c * ns:half + (c + 1) * ns]
        wc, wf = (w[:, :int(ln.max())].contiguous() for w, ln in (
            (wc, l6[c * ns:(c + 1) * ns]),
            (wf, l6[half + c * ns:half + (c + 1) * ns])))
        a = gc.decode_rgb_coarse(ip, c, dec, wc, lay)
        b = gc.decode_rgb_fine(ip, c, dec, a, wf, lay)
        if not (torch.equal(a, gc.decode_rgb_coarse_plain(ip, c, dec, wc,
                                                          lay))
                and torch.equal(b, gc.decode_rgb_fine_plain(ip, c, dec, a,
                                                            wf, lay))):
            raise RuntimeError(f"K4 RGB {tag} channel {c} differs from its "
                               "plain version")
        if c == 0:
            var = coder_variant("rans_decode", "rgb", K, 16)
            limit_line(f"K4 {var} RGB coarse {tag} NS={ns}", cuda_ms(
                lambda: gc.decode_rgb_coarse(ip, c, dec, wc, lay)), cuda_ms(
                lambda: gc.decode_rgb_coarse_plain(ip, c, dec, wc, lay), 1),
                coder_bound("dec rgb_coarse", ip, N, int(l6[:ns].sum())),
                lay.T)
            limit_line(f"K4 {var} RGB fine {tag} NS={ns}", cuda_ms(
                lambda: gc.decode_rgb_fine(ip, c, dec, a, wf, lay)), cuda_ms(
                lambda: gc.decode_rgb_fine_plain(ip, c, dec, a, wf, lay), 1),
                coder_bound("dec rgb_fine", ip, N,
                            int(l6[half:half + ns].sum())), lay.T)
        dec[c] = (a << 4) | b
    if not torch.equal(dec.long(), img.long()):
        raise RuntimeError(f"K3/K4 RGB {tag}: no round trip")
    log(f"[limits] K3/K4 RGB {tag}: words, lengths and symbols equal to the "
        "plain versions', round trip exact")


# ------------------------------------------------------------------ train

# K6 a launch when it ran one thread a pixel (ms, CUDA events around one
# call, the host's wrapper time included; NVIDIA H100 80GB HBM3, 700.00 W),
# by scale: (forward, backward); 1.182 ms a step
K6_ONE_THREAD_MS = ((0.205, 0.550), (0.096, 0.125), (0.099, 0.107))
# f32 operations of K6 per mixture term, counted from the expression
# csrc/dmll.cu evaluates, as one thread a pixel ran it (expf, log1pf, logf
# and a division 8 each): shared by every term the logits' max and softmax
# sum (10), the weighted sum and max (14) and the term's setup (clamp,
# x - mean, expf(-ls), p, m: 15); the branch: the interior two sigmoids,
# their difference, the clamp and the log (46), a tail one softplus and a
# sum (21); the RGB means add a sigmoid, a product and a sum per lambda
# (20 each: channel 1 one, channel 2 two). The backward recomputes the
# forward and adds the branch's derivative (interior 19, tail 18), the
# chain to d and ls (13) and, per term, the responsibility, the softmax
# weight and the five gradients (44); a lambda's gradient 8.
OPS_K6_TERM = 10 + 14 + 15
OPS_K6_BRANCH = {"interior": 46, "tail": 21}
OPS_K6_GRAD = {"interior": 19 + 13 + 44, "tail": 18 + 13 + 44}
OPS_K6_LAMBDA = ((0, 0), (20, 28), (40, 56))     # channel: (fwd, bwd)


def k6_bound(l_nchw, x, spec, grad: bool):
    """(ms, by) of one K6 launch on these inputs: l and x read once (and
    the upstream gradient), nll (grad_l and grad_x) written once; its
    operations, per term as counted above by the branch each element
    takes."""
    N, Kp, H, W = l_nchw.shape
    C = x.shape[-1]
    K = Kp // ((4 if spec.rgb_scale else 3) * C)
    tail = (x < spec.x_lower_bound) | (x > spec.x_upper_bound)
    n_tail = tail.sum(dim=(0, 1, 2)).double().cpu().tolist()  # per channel
    n_px = N * H * W
    ops = 0.0
    for c in range(C):
        lam = OPS_K6_LAMBDA[c][grad] if spec.rgb_scale else 0
        for kind, n in (("tail", n_tail[c]), ("interior", n_px - n_tail[c])):
            term = OPS_K6_TERM + OPS_K6_BRANCH[kind] + lam
            if grad:
                term += OPS_K6_GRAD[kind]
            ops += n * K * term
    n_bytes = (Kp + C) * n_px * 4 + (C * n_px * 4 if not grad
                                     else (Kp + 2 * C) * n_px * 4)
    return bound(n_bytes, ops)
# the fresh runs take 25 steps a seed (40 until the loader's phases grew
# the script past 900 s of its 1200: the loader-bound step is ~0.76 s
# there, and a run that is not stuck has left ~40 bpsp well before step 25)
TRAIN_STEPS_RESUMED, TRAIN_STEPS_FRESH, TRAIN_WARMUP = 20, 25, 3
# the resumed run's persistent checkpoints, every TRAIN_SAVE_EVERY steps:
# what phase host averages (SWA)
TRAIN_SAVE_EVERY = 5
# the resumed run's --log_train_heavy: the heavy summaries at steps 10, 20
TRAIN_HEAVY_EVERY = 10
# r5b resumed in bfloat16 (-p compute_dtype='bfloat16'): steps, and the
# first loss's tolerance against the bf16 eval forward's (the training
# forward reads the straight-through bottleneck, equal to the hard one up
# to a float32 rounding, which a bf16 cast may carry on)
TRAIN_STEPS_BF16, BF16_FIRST_LOSS_REL = 8, 1e-4
# cli.train --seed of the fresh runs: the validation bpsp must fall in a
# majority of them. Within its first steps a fresh run at cr.cf's lr can
# fall into a state where the loss stays at ~40 bpsp, and which runs do
# depends on the roundings of the gradient (a sum over k in another order
# sends seed 0 there, the plain version does not), so one seed's run
# would hold the kernel to its own roundings, not to training.
FRESH_SEEDS = (0, 1, 2)
TRAIN_IMGS, VAL_IMGS, TRAIN_SZ = 32, 8, 160


def train_pngs(d: str):
    """TRAIN_IMGS + VAL_IMGS images of TRAIN_SZ^2 from a seed (smooth
    random fields plus noise), written as PNGs by the port's writer;
    returns (train dir, val dir)."""
    rng = np.random.RandomState(1)
    yy, xx = np.mgrid[0:TRAIN_SZ, 0:TRAIN_SZ] / TRAIN_SZ
    dirs = []
    for sub, n in (("train", TRAIN_IMGS), ("val", VAL_IMGS)):
        os.makedirs(os.path.join(d, sub))
        for i in range(n):
            f = rng.uniform(0.5, 6.0, (3, 2))
            ph = rng.uniform(0, 2 * np.pi, (3,))
            base = np.stack([
                127 + 100 * np.sin(2 * np.pi * (f[c, 0] * yy + f[c, 1] * xx)
                                   + ph[c]) for c in range(3)], -1)
            img = np.clip(base + rng.normal(0, rng.uniform(2, 12),
                                            base.shape), 0, 255)
            write_png(os.path.join(d, sub, f"im{i:03d}.png"),
                      img.astype(np.uint8))
        dirs.append(os.path.join(d, sub))
    return dirs


@contextlib.contextmanager
def patched(cls, name, make):
    """cls.<name> replaced by make(original) for the block."""
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


def k6_agree(label, got, want):
    """Raises unless K6's (nll, grad_l, grad_x) are within the tight bound
    of tests/test_torch_port_kernels.py of the plain version's on every
    element (nll 1e-5 relative + 1e-6, its sum 1e-6 relative, grads 1e-5
    of the largest); returns (the stats line, nll's and the grads' max
    |diff|)."""
    stats, worst = [], [0.0, 0.0]
    for name, a, b in zip(("nll", "grad_l", "grad_x"), got, want):
        a, b = a.double(), b.double()
        err = (a - b).abs()
        sum_ok = True
        if name == "nll":
            tol = 1e-5 * b.abs() + 1e-6
            rel = float((err / b.abs().clamp(min=1e-6)).max())
            s_rel = abs(float(a.sum() - b.sum())) / max(abs(float(b.sum())),
                                                        1e-30)
            extra = f" max rel {rel:.2e}, sum rel {s_rel:.2e}"
            sum_ok = s_rel <= 1e-6
        else:
            scale = float(b.abs().max())
            tol = 1e-5 * scale
            extra = f" of max |grad| {scale:.3e}"
        n_out = int((err > tol).sum())
        stats.append(f"{name} max|diff| {float(err.max()):.3e}{extra}, "
                     f"{n_out}/{err.numel()} beyond the bound")
        if n_out or not sum_ok:
            raise RuntimeError(f"K6 {label} {name} disagrees with the plain "
                               f"version: {stats[-1]}")
        worst[name != "nll"] = max(worst[name != "nll"], float(err.max()))
    return "; ".join(stats), worst


def k6_grads(fn, spec, x, l_nchw, g):
    """(nll, grad_l in l_nchw's layout, grad_x) of fn on the NHWC view."""
    xr = x.clone().requires_grad_(True)
    lr = l_nchw.clone().requires_grad_(True)
    n = fn(spec, xr, lr.permute(0, 2, 3, 1))
    gl, gx = torch.autograd.grad(n, (lr, xr), g)
    return n.detach(), gl, gx


def phase_k6(net, cfg, batch, record):
    """K6 against its plain version on r5b's real outputs for one training
    batch (the training forward: straight-through bottlenecks), at the three
    scales, forward and backward, every element within the tight bound
    (k6_agree; the tests add each element's float32 spread for their
    adversarial inputs, which real outputs do not need). Times: CUDA events
    around one call (cuda_ms, the host's wrapper time included), as for
    the other kernels and as K6_ONE_THREAD_MS was taken, and device time a
    launch of 20 queued behind a sleeping kernel with L2 flushed between
    them (queued_ms), the records' device_ms. Returns
    the eval forward's loss_pc on the batch."""
    from l3c_torch.models import dmll
    x_img = torch.from_numpy(batch).cuda().float()
    with torch.no_grad():
        out = net(x_img, train=True)
        loss_eval = float(blueprint.compute_loss(
            cfg, net(x_img, train=False)).loss_pc)
    specs = [blueprint.rgb_spec(cfg)] + [blueprint.bn_spec(cfg)] * (
        len(out.P) - 1)
    rows = {"dmll_nll": [], "dmll_nll_grad": []}
    worst = {"dmll_nll": 0.0, "dmll_nll_grad": 0.0}
    flush_buf = torch.empty(32 * 2 ** 20, device="cuda")     # 128 MB > L2
    flush = lambda: torch.sum(flush_buf)
    baseline = cfg.rgb_bicubic_baseline
    for i, spec in enumerate(specs):
        x = (out.S[i].float() if i == 0 or baseline else out.bn[i]
             ).contiguous()
        l_nchw = out.P[i].permute(0, 3, 1, 2)        # the classifier's planes
        if not l_nchw.is_contiguous():
            raise RuntimeError("the training forward copied l")
        g = torch.ones_like(x)
        got = k6_grads(dmll.nll, spec, x, l_nchw, g)
        want = k6_grads(dmll.nll_plain, spec, x, l_nchw, g)
        torch.cuda.synchronize()
        stats, (w_nll, w_grad) = k6_agree(f"scale {i}", got, want)
        worst["dmll_nll"] = max(worst["dmll_nll"], w_nll)
        worst["dmll_nll_grad"] = max(worst["dmll_nll_grad"], w_grad)
        log(f"[train] K6 scale {i} {tuple(l_nchw.shape)} vs plain: {stats} "
            "(every element: nll 1e-5 rel + 1e-6, sum 1e-6 rel, grads 1e-5 "
            "of max)")
        del got, want
        consts = (spec.bin_width / 2.0, spec.x_lower_bound,
                  spec.x_upper_bound)
        f_call = lambda: kernels.dmll_nll(l_nchw, x, spec.rgb_scale, *consts)
        b_call = lambda: kernels.dmll_nll_grad(l_nchw, x, g, spec.rgb_scale,
                                               *consts)
        fwd, bwd = cuda_ms(f_call), cuda_ms(b_call)
        fwd_dev, bwd_dev = (queued_ms(f, flush=flush)
                            for f in (f_call, b_call))
        plain_f = cuda_ms(lambda: dmll.nll_plain(
            spec, x, l_nchw.permute(0, 2, 3, 1)), 3)
        plain_fb = cuda_ms(lambda: k6_grads(dmll.nll_plain, spec, x, l_nchw,
                                            g), 3)
        bf, bb = k6_bound(l_nchw, x, spec, False), k6_bound(l_nchw, x, spec,
                                                            True)
        rows["dmll_nll"].append((fwd, plain_f, bf, fwd_dev))
        rows["dmll_nll_grad"].append((bwd, plain_fb - plain_f, bb, bwd_dev))
        # the one-thread-a-pixel kernel's times are of cr.cf's shapes
        old = ((float("nan"),) * 2 if baseline else K6_ONE_THREAD_MS[i])
        log(f"[train] K6 scale {i}: forward {fwd * 1e3:.1f} us a launch by "
            f"events around one call (one thread a pixel {old[0] * 1e3:.0f}"
            f"), {fwd_dev * 1e3:.1f} us of device time, bound "
            f"{bf[0] * 1e3:.1f} us ({bf[1]}); backward {bwd * 1e3:.1f} us "
            f"(one thread a pixel {old[1] * 1e3:.0f}), device "
            f"{bwd_dev * 1e3:.1f} us, bound {bb[0] * 1e3:.1f} us ({bb[1]}) | "
            f"plain forward {plain_f * 1e3:.1f} us, forward+backward "
            f"{plain_fb * 1e3:.1f} us")
    for name, r in rows.items():
        n = len(r)
        by = {k: sum(t[2][0] for t in r if t[2][1] == k)
              for k in ("bytes", "operations")}
        log(f"[train] {name} per step ({n} launches): events around each "
            f"call {sum(t[0] for t in r):.4f} ms | device "
            f"{sum(t[3] for t in r):.4f} ms | plain "
            f"{sum(t[1] for t in r):.4f} ms | bound "
            f"{sum(t[2][0] for t in r):.4f} ms")
        record(name, worst[name], sum(t[0] for t in r) / n,
               sum(t[1] for t in r) / n,
               (sum(by.values()) / n, max(by, key=by.get)),
               sum(t[3] for t in r) / n)
    step = sum(t[0] for r in rows.values() for t in r)
    step_dev = sum(t[3] for r in rows.values() for t in r)
    log(f"[train] K6 per step: {step:.4f} ms by events around each call "
        f"(one thread a pixel: {sum(map(sum, K6_ONE_THREAD_MS)):.3f}), "
        f"{step_dev:.4f} ms of device time")
    del out
    return loss_eval


# K6 at shapes around its tile of 32 pixels (test_torch_port_kernels.py's
# ragged cases): (RGB scale, K, C, N, H, W)
K6_RAGGED = ((True, 10, 3, 1, 1, 1), (False, 10, 5, 3, 5, 7),
             (True, 3, 3, 3, 5, 7), (False, 3, 5, 2, 4, 13),
             (True, 10, 3, 2, 4, 13), (False, 10, 5, 2, 16, 12),
             (True, 10, 3, 1, 8, 16))


def k6_inputs(rgb, K, C, N, H, W, seed):
    """(x (N,H,W,C), l (N,Kp,H,W) NCHW, g) on the card, made with numpy
    as tests/test_torch_port_kernels.dmll_inputs makes them: both tails,
    log-scales far below and exactly at the -7 clamp, lambda logits."""
    rng = np.random.RandomState(seed)
    P = 4 if rgb else 3
    l = rng.randn(N, H, W, P, C, K).astype(np.float32) * 2.0
    l[..., 1, :, :] *= 40.0 if rgb else 0.4
    if rgb:
        l[..., 1, :, :] += 128.0
    sharp = rng.rand(N, H, W, C, K) < 0.2
    l[..., 2, :, :] = np.where(sharp, l[..., 2, :, :] * 3 - 9,
                               l[..., 2, :, :])
    l[..., 2, :, :][rng.rand(N, H, W, C, K) < 0.05] = -7.0
    if rgb:
        x = rng.randint(0, 256, (N, H, W, C)).astype(np.float32)
        x[rng.rand(N, H, W, C) < 0.15] = 0.0
        x[rng.rand(N, H, W, C) < 0.15] = 255.0
    else:
        x = np.linspace(-1.0, 1.0, 25).astype(np.float32)[
            rng.randint(0, 25, (N, H, W, C))]
        x[rng.rand(N, H, W, C) < 0.15] = -1.0
        x[rng.rand(N, H, W, C) < 0.15] = 1.0
    g = rng.rand(N, H, W, C).astype(np.float32)
    l = l.reshape(N, H, W, P * C * K).transpose(0, 3, 1, 2)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in (x, l, g))


def phase_k6_ragged(cfg):
    """K6 forward and backward on the card at K6_RAGGED's shapes against
    the card's plain version, every element within the tight bound, one
    launch each."""
    from l3c_torch.models import dmll
    for rgb, K, C, N, H, W in K6_RAGGED:
        spec = blueprint.rgb_spec(cfg) if rgb else blueprint.bn_spec(cfg)
        x, l_nchw, g = k6_inputs(rgb, K, C, N, H, W, N * H * W + K)
        kernels.reset_launches()
        got = k6_grads(dmll.nll, spec, x, l_nchw, g)
        if dict(kernels.launches) != {"dmll_nll": 1, "dmll_nll_grad": 1}:
            raise RuntimeError(f"K6 launches {dict(kernels.launches)}")
        want = k6_grads(dmll.nll_plain, spec, x, l_nchw, g)
        torch.cuda.synchronize()
        label = f"{'RGB' if rgb else 'bn'} K={K} C={C} {N}x{H}x{W}"
        stats, _ = k6_agree(label, got, want)
        log(f"[k6] {label} (HW % 32 = {H * W % 32}, HW % 4 = {H * W % 4}) "
            f"vs plain: {stats}")


def phase_train(net, cfg, card, keep):
    """Training on the card through the entry point a user calls
    (cli.train.main, in-process, no --device) at full cr.cf width with
    oi_offline.cf's shapes on seeded PNGs: K6 against its plain version on
    r5b's outputs; r5b resumed strictly and trained TRAIN_STEPS_RESUMED
    steps (its first loss equal to the eval forward's); the checkpoint it
    wrote coding a 512x512 image through cli.l3c; TRAIN_STEPS_FRESH steps
    from a fresh initialisation from each of FRESH_SEEDS, the validation
    bpsp falling in most; step time and memory of the first, and one
    profiled step. Every train step launches exactly 3 + 3
    K6 kernels and calls the plain nll on no CUDA tensor. The resumed
    run saves a persistent checkpoint every TRAIN_SAVE_EVERY steps; its
    log dir is copied under `keep` for phase host's SWA, and its path
    returned beside the records."""
    from l3c_torch.cli import train as train_cli
    from l3c_torch.data.images import TrainBatches
    from l3c_torch.models import dmll
    from l3c_torch.models.weights import read_checkpoint
    from l3c_torch.train.trainer import Trainer
    ms_cf = os.path.join(l3c_cli.default_config_roots()[0], "ms", "cr.cf")
    dl_cf = os.path.join(l3c_cli.default_config_roots()[0], "dl",
                         "oi_offline.cf")
    per_step = {"dmll_nll": 3, "dmll_nll_grad": 3}
    with tempfile.TemporaryDirectory(prefix="l3c_train_") as d:
        pending = []
        train_dir, val_dir = train_pngs(d)
        data = ["-p", f"dl.train_imgs_glob='{train_dir}'", "-p",
                f"dl.val_glob='{val_dir}'", "-p", "dl.image_cache_pkl=None"]
        # the first batch cli.train draws (TrainBatches is deterministic)
        dl = load_dl_config(dl_cf)
        tb = TrainBatches(sorted(os.path.join(train_dir, f)
                                 for f in os.listdir(train_dir)),
                          dl.batchsize_train, dl.crop_size, seed=0,
                          aug_strong=dl.aug_strong)
        batch = next(iter(tb))
        tb.close()
        loss_eval = phase_k6(net, cfg, batch, lambda *a: pending.append(a))

        # ---- resume r5b strictly, TRAIN_STEPS_RESUMED steps at a constant
        # lr (exp_0.75_e5 in epochs of this corpus would be ~0 at step
        # 246250)
        root = os.path.join(d, "logs")
        os.makedirs(root)
        os.symlink(os.path.dirname(os.path.dirname(CKPT)),
                   os.path.join(root, os.path.basename(
                       os.path.dirname(os.path.dirname(CKPT)))))
        r5b = read_checkpoint(CKPT)
        seen = {"losses": [], "steps": [], "starts": []}

        def restore(orig):
            def run(self, *a, **k):
                got = orig(self, *a, **k)
                st = self.state_tree()
                flat = lambda t, p="": (
                    [x for k_, v in sorted(t.items())
                     for x in flat(v, f"{p}/{k_}")]
                    if isinstance(t, dict) else [(p, t)])
                a_, b_ = flat(st), flat(r5b)
                same = len(a_) == len(b_) and all(
                    pa == pb and va.dtype == vb.dtype and np.array_equal(va, vb)
                    for (pa, va), (pb, vb) in zip(a_, b_))
                log(f"[train] restored itr {got}: {len(a_)} leaves (params, "
                    f"nu, count {int(st['opt_state']['1']['count'])}, step "
                    f"{int(st['step'])}) equal to r5b's: {same}")
                if not same:
                    raise RuntimeError("r5b did not resume strictly")
                return got
            return run

        def step(orig):
            def run(self, batch_):
                before = dict(kernels.launches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                seen["starts"].append(t0)
                m = orig(self, batch_)
                torch.cuda.synchronize()
                seen["steps"].append(time.perf_counter() - t0)
                seen["losses"].append(float(m["loss_bpsp"]))
                seen["lr"] = float(m["lr"])
                seen["trainer"] = self
                got = {k: kernels.launches.get(k, 0) - before.get(k, 0)
                       for k in kernels.KERNELS}
                if got != {k: per_step.get(k, 0) for k in kernels.KERNELS}:
                    raise RuntimeError(f"a train step launched {got}")
                return m
            return run

        plain = {"nll_plain": 0}
        unpatch = count_cuda_calls(dmll, ["nll_plain"], plain)
        heavy = HeavyRecorder()
        try:
            with patched(Trainer, "restore", restore), \
                    patched(Trainer, "train_step", step), \
                    heavy.recording():
                kernels.reset_launches()
                run_cli(train_cli.main, [
                    ms_cf, dl_cf, root, *data, "-p", "lr.schedule='none'",
                    "--restore", LOG_DATE, "--num_itr",
                    str(TRAIN_STEPS_RESUMED), "--log_train", "5",
                    "--log_val", "0", "--log_train_heavy",
                    str(TRAIN_HEAVY_EVERY), "--keep_tmp_itr",
                    str(TRAIN_SAVE_EVERY), "--keep_every", "1"])
                resumed = dict(kernels.launches)
        finally:
            unpatch()
        heavy.check(cfg, dl, card)
        want = {k: TRAIN_STEPS_RESUMED * v for k, v in per_step.items()}
        log(f"[train] launches of the resumed run: "
            f"{ {k: v for k, v in resumed.items() if v} } (expected {want}); "
            f"plain nll calls on CUDA tensors: {plain['nll_plain']}")
        if {k: resumed.get(k, 0) for k in want} != want or any(
                resumed.get(k, 0) for k in CODEC_KERNELS) or \
                plain["nll_plain"]:
            raise RuntimeError("the resumed run did not train through K6 "
                               "alone")
        losses = seen["losses"]
        resumed_losses = list(losses)
        rel = abs(losses[0] - loss_eval) / loss_eval
        log(f"[train] resumed r5b: lr {seen['lr']:.3e}; first step loss_bpsp "
            f"{losses[0]:.7f} vs the eval forward's loss_pc {loss_eval:.7f} "
            f"(rel {rel:.2e}); losses {[round(v, 4) for v in losses]}")
        if rel > 1e-5 or not all(math.isfinite(v) for v in losses):
            raise RuntimeError("resumed losses wrong or not finite")
        new_dir = [n for n in os.listdir(root) if not n.startswith(LOG_DATE)]
        if len(new_dir) != 1:
            raise RuntimeError(f"expected one new log dir: {new_dir}")
        end = 246250 + TRAIN_STEPS_RESUMED
        ck = os.path.join(root, new_dir[0], "ckpts",
                          f"ckpt_{end:010d}.ckpt")
        saved = read_checkpoint(ck)
        shape = lambda t: ({k: shape(v) for k, v in t.items()}
                           if isinstance(t, dict) else (t.shape, t.dtype.str))
        if shape(saved) != shape(r5b) or int(saved["step"]) != end:
            raise RuntimeError("the saved checkpoint is not shaped as r5b's")
        log(f"[train] {new_dir[0]}/ckpts/{os.path.basename(ck)}: r5b's keys, "
            f"shapes and dtypes, step {int(saved['step'])}, count "
            f"{int(saved['opt_state']['1']['count'])}")

        # ---- train to serve: that checkpoint codes a 512x512 image
        src, coded = os.path.join(d, "serve.png"), os.path.join(d, "s.l3c")
        back = os.path.join(d, "back.png")
        img = bench_images()[0][0]
        write_png(src, img)
        date = new_dir[0].split()[0]
        total = {}
        counted(total, "cli.l3c enc (trained)", lambda: run_cli(
            l3c_cli.main, [root, date, "enc", src, coded]), ENCODE, CANARY)
        counted(total, "cli.l3c dec (trained)", lambda: run_cli(
            l3c_cli.main, [root, date, "dec", coded, back]), DECODE, CANARY)
        if not np.array_equal(read_png(back), img):
            raise RuntimeError("the trained checkpoint did not code the "
                               "image bit-exactly")
        log(f"[train] cli.l3c enc+dec with {new_dir[0]} (step {end}): "
            f"bit-exact, file bpsp {os.path.getsize(coded) * 8 / img.size:.6f}")
        resumed_dir = os.path.join(keep, new_dir[0])
        shutil.copytree(os.path.join(root, new_dir[0]), resumed_dir)

        # ---- bfloat16: r5b resumed at the same settings with -p
        # compute_dtype='bfloat16'
        bf_cfg, bf_net = with_dtype(cfg, net, "bfloat16")
        with torch.no_grad():
            loss_bf = float(blueprint.compute_loss(bf_cfg, bf_net(
                torch.from_numpy(batch).cuda().float())).loss_pc)
        del bf_net
        root_bf = os.path.join(d, "logs_bf16")
        os.makedirs(root_bf)
        os.symlink(os.path.dirname(os.path.dirname(CKPT)),
                   os.path.join(root_bf, os.path.basename(
                       os.path.dirname(os.path.dirname(CKPT)))))
        seen.update(losses=[], steps=[], starts=[])
        plain["nll_plain"] = 0
        unpatch = count_cuda_calls(dmll, ["nll_plain"], plain)
        try:
            with patched(Trainer, "restore", restore), \
                    patched(Trainer, "train_step", step):
                kernels.reset_launches()
                run_cli(train_cli.main, [
                    ms_cf, dl_cf, root_bf, *data, "-p", "lr.schedule='none'",
                    "-p", "compute_dtype='bfloat16'", "--restore", LOG_DATE,
                    "--num_itr", str(TRAIN_STEPS_BF16), "--log_train", "4",
                    "--log_val", "0"])
                bf_launches = dict(kernels.launches)
        finally:
            unpatch()
        want = {k: TRAIN_STEPS_BF16 * v for k, v in per_step.items()}
        losses = seen["losses"]
        rel = abs(losses[0] - loss_bf) / loss_bf
        bf_ms = statistics.median(seen["steps"][TRAIN_WARMUP:]) * 1e3
        log(f"[train] bf16: r5b resumed {TRAIN_STEPS_BF16} steps with "
            f"compute_dtype='bfloat16': first loss_bpsp {losses[0]:.7f} vs "
            f"the bf16 eval forward's {loss_bf:.7f} (rel {rel:.2e}; float32 "
            f"eval {loss_eval:.7f}); losses {[round(v, 4) for v in losses]};"
            f" step {bf_ms:.2f} ms (median after {TRAIN_WARMUP} warm-up); "
            f"launches { {k: v for k, v in bf_launches.items() if v} }; "
            f"plain nll calls on CUDA tensors {plain['nll_plain']} | {card}")
        if {k: bf_launches.get(k, 0) for k in want} != want or \
                plain["nll_plain"]:
            raise RuntimeError("bf16 training did not run through K6 alone")
        if rel > BF16_FIRST_LOSS_REL or not all(math.isfinite(v)
                                                for v in losses):
            raise RuntimeError("bf16 resumed losses wrong or not finite")
        conv_determinism(seen["trainer"].net, batch)
        profile_step(seen["trainer"], batch, bf_ms)
        seen.pop("trainer")

        # ---- fresh initialisation, TRAIN_STEPS_FRESH steps a seed
        vals, falls = {}, []

        def train(orig):
            def run(self, *a, **k):
                vals["before"] = self.validation_loop()
                out_ = orig(self, *a, **k)
                vals["after"] = self.validation_loop()
                return out_
            return run

        for seed in FRESH_SEEDS:
            seen.update(losses=[], steps=[], starts=[])
            torch.cuda.reset_peak_memory_stats()
            plain["nll_plain"] = 0
            unpatch = count_cuda_calls(dmll, ["nll_plain"], plain)
            try:
                with patched(Trainer, "train", train), \
                        patched(Trainer, "train_step", step):
                    kernels.reset_launches()
                    run_cli(train_cli.main, [
                        ms_cf, dl_cf, os.path.join(d, f"fresh{seed}"), *data,
                        "--seed", str(seed), "--num_itr",
                        str(TRAIN_STEPS_FRESH), "--log_train", "10",
                        "--log_val", "0"])
                    fresh = dict(kernels.launches)
            finally:
                unpatch()
            falls.append(vals["after"] < vals["before"])
            log(f"[train] fresh init, seed {seed}, {TRAIN_STEPS_FRESH} steps: "
                f"validation bpsp {vals['before']:.4f} -> {vals['after']:.4f};"
                f" launches { {k: v for k, v in fresh.items() if v} }; plain "
                f"nll calls on CUDA tensors {plain['nll_plain']}")
            if plain["nll_plain"]:
                raise RuntimeError("fresh training ran the plain nll on the "
                                   "card")
            if seed == FRESH_SEEDS[0]:
                peak = torch.cuda.max_memory_allocated()
                steps = seen["steps"][TRAIN_WARMUP:]
                starts = seen["starts"][TRAIN_WARMUP:]
        if 2 * sum(falls) <= len(falls):
            raise RuntimeError(f"fresh training lowered the validation bpsp "
                               f"in {sum(falls)} of {len(falls)} seeds")
        med = statistics.median(steps) * 1e3
        loop = statistics.median(b - a for a, b in zip(starts, starts[1:]))
        log(f"[train] step time (batch {dl.batchsize_train} x "
            f"{dl.crop_size}^2, full cr.cf, host clock around a synchronised "
            f"step, median of {len(steps)} after {TRAIN_WARMUP} warm-up): "
            f"{med:.2f} ms = {dl.batchsize_train * 1e3 / med:.1f} img/s "
            f"(min {min(steps) * 1e3:.2f}, max {max(steps) * 1e3:.2f}) | the "
            f"training loop, waits for the loader's batches included: median "
            f"{loop * 1e3:.2f} ms from a step's start to the next's = "
            f"{dl.batchsize_train / loop:.1f} img/s | peak memory "
            f"{peak / 2 ** 30:.3f} GiB | {card}")
        profile_step(seen["trainer"], batch, med)
    recs = []
    record = make_recorder(recs, resumed, "train")
    for args in pending:
        record(*args)
    return recs, resumed_dir, resumed_losses


# ------------------------------------------------------------- baselines

# fresh cli.train steps of each RGB baseline (cr_rgb, cr_rgb_shared) at
# oi_offline.cf's batch 16 x 128^2, from --seed 0
BASE_STEPS = 30


def codec_launches(cfg):
    """(an encode's, a decode's) launches of a float batch, from the
    codec's structure: unit 0 and one unit per bn scale coded alone, an
    RGB scale's two units in one encode and six decodes (three channels,
    coarse and fine); one pack a scale on either side. cr.cf: ENCODE,
    DECODE."""
    S = cfg.num_scales
    rgb = S if cfg.rgb_bicubic_baseline else 1
    return ({"rans_encode": 1 + S, "pack_int": S},
            {"rans_decode": 1 + (S - rgb) + 6 * rgb, "pack_int": S})


def theory_launches(cfg, n_imgs, recursive=0):
    """K6 forward launches of the theory bpsp of n_imgs images (one
    auto-crop tile each): one a scale, recursed ones included."""
    return {"dmll_nll": (cfg.num_scales + recursive) * n_imgs}


def train_fresh(train_cli, ms_cf, dl_cf, log_root, data, steps, label):
    """cli.train of `ms_cf` from a fresh initialisation (--seed 0) for
    `steps` steps, launch-counted; the validation bpsp before and after
    (held to fall); returns (the new log dir's date, the run's
    launches)."""
    from l3c_torch.train.trainer import Trainer
    vals = {}

    def train(orig):
        def run(self, *a, **k):
            vals["before"] = self.validation_loop()
            out_ = orig(self, *a, **k)
            vals["after"] = self.validation_loop()
            vals["n_val"] = len(self.val_batches)
            return out_
        return run

    cfg = load_ms_config(ms_cf)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with patched(Trainer, "train", train):
        run_cli(train_cli.main, [ms_cf, dl_cf, log_root, *data, "--num_itr",
                                 str(steps), "--log_train", "10",
                                 "--log_val", "0"])
    secs = time.perf_counter() - t0
    got = {k: v for k, v in kernels.launches.items() if v}
    S = cfg.num_scales
    want = {"dmll_nll": steps * S + 2 * vals["n_val"] * S,
            "dmll_nll_grad": steps * S}
    log(f"[baselines] {label}: {steps} fresh steps through cli.train in "
        f"{secs:.1f} s: validation bpsp {vals['before']:.4f} -> "
        f"{vals['after']:.4f}; launches {got} (expected {want})")
    if got != want:
        raise RuntimeError(f"{label} training launched {got}")
    if not vals["after"] < vals["before"]:
        raise RuntimeError(f"{label}: fresh training did not lower the "
                           "validation bpsp")
    (name,) = os.listdir(log_root)
    return name.split()[0], got


def phase_baselines(imgs, card, keep):
    """The RGB baselines on the card through the entry points a user
    calls, at cr_rgb.cf's and cr_rgb_shared.cf's full width from fresh
    weights: cr_rgb trained BASE_STEPS steps (K6 on C = 3 with lambda at
    every scale), then through cli.test (theory bpsp of the 8 images) and
    cli.test --write_to_files (size profile, all 10 components, the
    tester's bit-exact gate) and TorchBitcoding's balanced top-4 round at
    fbatch 8, launch-counted (K5 at every scale with the RGB spec, K3/K4 in
    RGB modes at every scale and at L = 256 for unit 0), each kernel of
    that round and K6 on its training forward held to its plain version
    and timed (the `baselines` records); cli.test --sample of the trained
    model; cr_rgb_shared trained the same way, then cli.test --recursive
    auto (three recursions) and its non-recursive v8 round trip (unit 0
    the whole x2-downsampled image at L = 256). The trained cr_rgb's log
    dir is copied under `keep` for phase host; returns (records, its log
    root, its date)."""
    from l3c_torch.cli import train as train_cli
    from l3c_torch.data.images import TrainBatches
    roots = l3c_cli.default_config_roots()
    dl_cf = os.path.join(roots[0], "dl", "oi_offline.cf")
    recs = []
    with tempfile.TemporaryDirectory(prefix="l3c_base_") as d:
        train_dir, val_dir = train_pngs(d)
        data = ["-p", f"dl.train_imgs_glob='{train_dir}'", "-p",
                f"dl.val_glob='{val_dir}'", "-p", "dl.image_cache_pkl=None"]
        img_dir = os.path.join(d, "imgs")
        os.makedirs(img_dir)
        for b, im in enumerate(imgs):
            write_png(os.path.join(img_dir, f"im{b}.png"), im[0])
        # ---- cr_rgb: train, then serve
        ms_cf = os.path.join(roots[0], "ms", "cr_rgb.cf")
        cfg = load_ms_config(ms_cf)
        log_root = os.path.join(d, "cr_rgb")
        date, trained = train_fresh(train_cli, ms_cf, dl_cf, log_root, data,
                                    BASE_STEPS, "cr_rgb")
        enc_l, dec_l = codec_launches(cfg)
        total = {}
        out = counted(total, "cli.test (cr_rgb)", lambda: run_cli(
            test_cli.main, [log_root, date, img_dir, "--reset_cache"]),
            theory_launches(cfg, B))
        theory = float(out.strip().splitlines()[-1].split()[-1])
        out_dir = os.path.join(d, "out")
        out = counted(total, "cli.test --write_to_files (cr_rgb)",
                      lambda: run_cli(test_cli.main, [
                          log_root, date, img_dir, "--write_to_files",
                          out_dir, "--reset_cache"]), enc_l, dec_l, CANARY)
        size_bpsp = float(out.strip().splitlines()[-1].split()[-1])
        log(f"[baselines] cr_rgb (fresh, {BASE_STEPS} steps): theory bpsp "
            f"{theory:.4f}; cli.test --write_to_files {B} files bit-exact "
            f"(size profile, K'={cfg.prob.K}): {size_bpsp:.4f} | {card}")
        tester = MultiscaleTester.from_log_dir(find_log_dir(log_root, date),
                                               roots, use_cache=False)
        bc = TorchBitcoding(cfg, tester.net, device="cuda",
                            coder_profile="balanced", coder_topk=4)
        counts = baseline_round(bc, imgs, enc_l, dec_l, theory, card,
                                "cr_rgb")
        # K3-K5 launches: the counted round's; K6's: the training run's
        record = make_recorder(recs, {**trained, **counts}, "baselines")
        logits = {}
        phase_coder(bc, coder_cases(bc, imgs, logits), record)
        phase_pack(bc, logits, record)
        del logits
        unit0_lines(cfg, tester.net, imgs, "cr_rgb")
        tb = TrainBatches(sorted(os.path.join(train_dir, f)
                                 for f in os.listdir(train_dir)),
                          16, 128, seed=0)
        batch = next(iter(tb))
        tb.close()
        phase_k6(tester.net, cfg, batch, record)
        phase_sample(log_root, date, [imgs[0], imgs[1]], cfg, card,
                     "cr_rgb (fresh)")
        del bc, tester
        kept_root = os.path.join(keep, "cr_rgb")
        shutil.copytree(log_root, kept_root)
        kept = (kept_root, date)
        # ---- cr_rgb_shared: train, theory with recursion, round trip
        ms_cf = os.path.join(roots[0], "ms", "cr_rgb_shared.cf")
        cfg = load_ms_config(ms_cf)
        log_root = os.path.join(d, "cr_rgb_shared")
        date, _ = train_fresh(train_cli, ms_cf, dl_cf, log_root, data,
                              BASE_STEPS, "cr_rgb_shared")
        out = counted(total, "cli.test --recursive auto (cr_rgb_shared)",
                      lambda: run_cli(test_cli.main, [
                          log_root, date, img_dir, "--recursive", "auto",
                          "--reset_cache"]),
                      theory_launches(cfg, B, recursive=3))
        rec_bpsp = float(out.strip().splitlines()[-1].split()[-1])
        tester = MultiscaleTester.from_log_dir(
            find_log_dir(log_root, date), roots, use_cache=False,
            recursive="auto")
        res = tester.test(Testset(img_dir)).mean_bpsp()
        t0 = MultiscaleTester(cfg, tester.net, use_cache=False)
        plain_bpsp = t0.test(Testset(img_dir)).mean_bpsp()
        # the tester reports the non-recursive sum (scale 0 and the tail
        # of its x2 image, as the JAX tester does); the recursed pyramid's
        # own bpsps are the loss's recursive_bpsps
        with torch.inference_mode():
            x = torch.from_numpy(np.concatenate(imgs)).cuda().float()
            loss = blueprint.compute_loss(
                cfg, tester.net(x, auto_recurse=3), auto_recursive_from=1)
            rec = [float(b) for b in loss.recursive_bpsps]
            non = [float(b) for b in loss.nonrecursive_bpsps]
        log(f"[baselines] cr_rgb_shared (fresh, {BASE_STEPS} steps): "
            f"cli.test --recursive auto (3) theory bpsp {rec_bpsp:.4f} "
            f"(tester {res:.6f}); without recursion {plain_bpsp:.6f}; the "
            f"8 images' forward with 3 recursions: non-recursive "
            f"{[round(b, 4) for b in non]} = {sum(non):.4f}, recursive "
            f"{[round(b, 4) for b in rec]} = {sum(rec):.4f} | {card}")
        if tester.recursive != 3 or f"{res:.4f}" != f"{rec_bpsp:.4f}" or \
                not all(math.isfinite(b) and b > 0 for b in rec + [res]) \
                or len(rec) != 5 or abs(sum(non) - res) > 1e-4 * res:
            raise RuntimeError("cr_rgb_shared's recursive bpsp is wrong")
        enc_l, dec_l = codec_launches(cfg)
        bc = TorchBitcoding(cfg, tester.net, device="cuda",
                            coder_profile="balanced", coder_topk=4)
        baseline_round(bc, imgs, enc_l, dec_l, plain_bpsp, card,
                       "cr_rgb_shared")
        # its unit 0 (the whole x2 image at L = 256); its scale-0 units are
        # cr_rgb's kind
        unit0_lines(cfg, tester.net, imgs, "cr_rgb_shared")
        del bc, tester, t0
    return recs, kept


def unit0_lines(cfg, net, imgs, label):
    """A baseline's unit 0 (uniform, L = 256) alone, K3 and K4 at the
    balanced profile (the round's) and at size (cli.test --write_to_files'),
    each held to its plain version and timed with its variant, NS and T."""
    for profile in ("balanced", "size"):
        bc = TorchBitcoding(cfg, net, device="cuda", coder_profile=profile)
        cases = [c for c in coder_cases(bc, imgs)
                 if c.label.startswith("uniform")]
        for c, ms, _ in phase_coder(bc, cases, None):
            coder_line(f"[baselines] {label} unit 0 {profile}", c, ms)


def baseline_round(bc, imgs, enc_l, dec_l, theory, card, label):
    """One encode + decode round of a baseline's codec at fbatch 8 after a
    warm-up one: bit-exact, exactly enc_l + dec_l launches (the canary
    computed before), no int_coder row/lookup or plain pack call on the
    card; its time and its device time (torch.profiler). Returns the
    counted round's launches."""
    plain_calls = {name: 0 for name in INT_CODER_ROWS + PLAIN_PACK}
    with tempfile.TemporaryDirectory(prefix="l3c_bround_") as d:
        paths = [os.path.join(d, f"w{b}.l3c") for b in range(B)]
        bc.encode_batch(imgs, paths)            # warm-up, canary
        bc.decode_batch(paths)
        paths = [os.path.join(d, f"r{b}.l3c") for b in range(B)]
        restore = count_cuda_calls(int_coder, INT_CODER_ROWS + PLAIN_PACK,
                                   plain_calls)
        try:
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bpsps = bc.encode_batch(imgs, paths)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            outs = bc.decode_batch(paths)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            counts = dict(kernels.launches)
        finally:
            restore()
        for im, o in zip(imgs, outs):
            if not np.array_equal(o, im):
                raise RuntimeError(f"{label}: round trip is NOT bit-exact")
        paths2 = [os.path.join(d, f"p{b}.l3c") for b in range(B)]
        busy = device_busy_ms(lambda: (bc.encode_batch(imgs, paths2),
                                       bc.decode_batch(paths2)))
    want = {k: enc_l.get(k, 0) + dec_l.get(k, 0) for k in kernels.KERNELS}
    got = {k: counts.get(k, 0) for k in kernels.KERNELS}
    log(f"[baselines] {label} round: launches "
        f"{ {k: v for k, v in got.items() if v} }; plain row/lookup/pack "
        f"calls on the card {sum(plain_calls.values())}")
    if got != want or any(plain_calls.values()):
        raise RuntimeError(f"{label}: the round launched {got}, expected "
                           f"{want}, plain calls {plain_calls}")
    e, dd = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    mp = B * SZ * SZ / 1e6
    log(f"[baselines] {label}: bit-exact {B}x{SZ}x{SZ} fbatch 8 balanced "
        f"top-4 | file bpsp {np.mean(bpsps):.6f} vs theory {theory:.6f} | "
        f"enc {e:.1f} ms dec {dd:.1f} ms = {mp / (e + dd) * 1e3:.3f} MP/s "
        f"| device busy {busy:.1f} ms of a round | {card}")
    return counts


# ---------------------------------------------------------------- sample

# cli.test --sample writes these per image (the JAX tester's names)
SAMPLE_SETS = ("", "0", "0_1")


def phase_sample(log_root, date, sample_imgs, cfg, card, label):
    """cli.test --sample of two of the 512x512 images: the three scale
    sets' PNGs per image, named as the JAX package names them, the padded
    image's shape; the call launches exactly the theory bpsp's K6 (sampling
    itself is plain PyTorch). Prints each set's mean |sample - image|."""
    with tempfile.TemporaryDirectory(prefix="l3c_sample_") as d:
        img_dir, out_dir = os.path.join(d, "imgs"), os.path.join(d, "out")
        os.makedirs(img_dir)
        for b, im in enumerate(sample_imgs):
            write_png(os.path.join(img_dir, f"s{b}.png"), im[0])
        t0 = time.perf_counter()
        counted({}, f"cli.test --sample ({label})", lambda: run_cli(
            test_cli.main, [log_root, date, img_dir, "--sample", out_dir,
                            "--reset_cache"]),
            theory_launches(cfg, len(sample_imgs)))
        secs = time.perf_counter() - t0
        want = sorted(f"s{b}_sample{s}.png" for b in range(len(sample_imgs))
                      for s in SAMPLE_SETS)
        if sorted(os.listdir(out_dir)) != want:
            raise RuntimeError(f"--sample wrote {os.listdir(out_dir)}")
        gaps = []
        for b, im in enumerate(sample_imgs):
            for s in SAMPLE_SETS:
                px = read_png(os.path.join(out_dir, f"s{b}_sample{s}.png"))
                if px.shape != im[0].shape or px.dtype != np.uint8:
                    raise RuntimeError(f"sample {px.shape} {px.dtype}")
                gaps.append(float(np.abs(px.astype(np.float64)
                                         - im[0]).mean()))
    log(f"[sample] {label}: cli.test --sample of {len(sample_imgs)} "
        f"{SZ}x{SZ} PNGs in {secs:.1f} s: {len(want)} PNGs (uint8, "
        f"{SZ}x{SZ}x3); mean |sample - image| per set "
        f"{[round(g, 2) for g in gaps]} | {card}")


def phase_stages(net, cfg, imgs, card):
    """The plain-PyTorch device stages the baselines, sampling and the
    heavy summaries put on a path, timed on 8 x 512^2 (CUDA events around
    one call) against their bounds: bicubic_downsample_x2 (the pyramid's
    first level from the float image; bytes: the image in, the half-size
    image out, float32), dmll.sample and mean_symbol_probs (L = 256) on
    r5b's scale-0 mixture (bytes: l and x in, the draws or the L values
    out; operations as counted below)."""
    from l3c_torch.models import dmll
    dev = next(net.parameters()).device
    x = torch.from_numpy(np.concatenate(imgs)).to(dev).float()
    n_px = x.numel() // 3
    ms = cuda_ms(lambda: layers.bicubic_downsample_x2(x))
    # two passes of 8 taps, a multiply and an add each, per output value
    b = bound(x.numel() * 4 + x.numel() // 4 * 4,
              2 * 8 * 2 * x.numel() // 2)
    log(f"[stages] bicubic_downsample_x2 {tuple(x.shape)}: {ms:.4f} ms | "
        f"bound {b[0]:.4f} ms ({b[1]}) | {card}")
    with torch.inference_mode():
        l = net(x).P[0]
    K = cfg.prob.K
    spec = blueprint.rgb_spec(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    ms = cuda_ms(lambda: dmll.sample(spec, l, 3, g))
    # per (pixel, channel): K Gumbel terms (two logs and a subtraction) and
    # the argmax, one logistic draw (exp, two logs), the lambda chain
    b = bound(l.numel() * 4 + x.numel() * 4,
              n_px * 3 * (K * (2 * OPS_EXP + 2) + 3 * OPS_EXP + 8))
    log(f"[stages] dmll.sample {tuple(l.shape)}: {ms:.4f} ms | bound "
        f"{b[0]:.4f} ms ({b[1]}) | {card}")
    p_y = dmll.mean_symbol_probs(spec, x, l)
    if abs(float(p_y.sum()) - 1) > 1e-3 or float(p_y.min()) < -1e-6:
        raise RuntimeError(f"mean_symbol_probs sums to {float(p_y.sum())}")
    ms = cuda_ms(lambda: dmll.mean_symbol_probs(spec, x, l), 3)
    # per (pixel, channel, component) and interior edge: subtract,
    # multiply, sigmoid (exp, add, divide), weight, sum
    b = bound(l.numel() * 4 + x.numel() * 4 + spec.L * 4,
              n_px * 3 * K * (spec.L - 1) * (4 + 2 * OPS_EXP))
    log(f"[stages] mean_symbol_probs L={spec.L} {tuple(l.shape)}: "
        f"{ms:.4f} ms | bound {b[0]:.4f} ms ({b[1]}) | {card}")


class HeavyRecorder:
    """The heavy summaries of a cli.train run, recorded: recording() puts a
    writer that keeps every tag (the card has no tensorboard, so SafeWriter
    would drop them) in place of SafeWriter, records ps_figure's inputs
    (the card has no matplotlib, so no figure is drawn) and times each
    Trainer._write_heavy_summaries call (synchronised); check() holds what
    they hold."""

    def __init__(self):
        self.tags = {"scalar": set(), "image": set(), "histogram": set(),
                     "histogram_counts": set(), "figure": set()}
        self.counts, self.stats, self.ms = {}, [], []

    @contextlib.contextmanager
    def recording(self):
        from l3c_torch.train import trainer as trainer_mod
        from l3c_torch.utils import summarizer
        rec = self

        class Writer:
            def __init__(self, log_dir):
                pass

            def __getattr__(self, name):
                kind = name[len("add_"):]

                def add(tag, value, *a, **k):
                    rec.tags[kind].add(tag)
                    if kind == "histogram_counts":
                        rec.counts[tag] = np.asarray(value)
                return add

            def close(self):
                pass

        def figure(p_x, p_y):
            self.stats.append((np.asarray(p_x), np.asarray(p_y)))
            return None

        def timed(orig):
            def run(trainer, *a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                orig(trainer, *a, **k)
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                if len(self.ms) == 1:
                    # once more, profiled; what it adds is dropped again
                    bufs = {t: list(b) for t, b in
                            trainer._hist_buffers.items()}
                    n_stats = len(self.stats)
                    self.profile(lambda: orig(trainer, *a, **k))
                    trainer._hist_buffers = bufs
                    del self.stats[n_stats:]
            return run

        with patched(summarizer, "SafeWriter", lambda _: Writer), \
                patched(trainer_mod, "ps_figure", lambda _: figure), \
                patched(trainer_mod.Trainer, "_write_heavy_summaries",
                        timed):
            yield

    @staticmethod
    def profile(fn):
        """One more heavy step under torch.profiler: its device time and
        the ops that take the most host and device time."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        kern = [e for e in ev if str(e.device_type).endswith("CUDA")
                and getattr(e, "self_device_time_total", 0) > 0]
        log(f"[train] a heavy step, profiled: device busy "
            f"{sum(e.self_device_time_total for e in kern) / 1e3:.2f} ms in "
            f"{sum(e.count for e in kern)} kernels")
        for key in ("self_cpu_time_total", "self_device_time_total"):
            for e in sorted(ev, key=lambda e: -getattr(e, key, 0))[:6]:
                log(f"[train]   by {key[5:8]} {getattr(e, key) / 1e3:8.2f} ms "
                    f"{e.count:5d}x {e.key[:70]}")

    def check(self, cfg, dl, card):
        """Two heavy steps of cr.cf: an image per bottleneck channel and a
        symbol histogram per bottleneck (scales 1..S), the encoders' activation
        counts (summed over the buffered steps: the training batch's
        activations twice), and per scale the observed counts of the first
        validation image's symbols and a predicted distribution summing to
        1."""
        S, C = cfg.num_scales, cfg.q.C
        n_heavy = TRAIN_STEPS_RESUMED // TRAIN_HEAVY_EVERY
        want_img = {f"train_heavy/bn/{s}/c{c}" for s in range(1, S + 1)
                    for c in range(C)}
        want_cnt = {f"train/histo/enc_{s}_after_1x1" for s in range(1, S + 1)}
        side = dl.crop_size
        acts = [n_heavy * dl.batchsize_train * (side >> s) ** 2 * C
                for s in range(1, S + 1)]
        got = [int(self.counts[t].sum()) for t in sorted(want_cnt)]
        subpx = [side * side * 3] + [(side >> s) ** 2 * C
                                     for s in range(1, S)]
        bad = (self.tags["image"] != want_img
               or self.tags["histogram"] != {f"train_heavy/bn_syms/{s}"
                                             for s in range(1, S + 1)}
               or self.tags["histogram_counts"] != want_cnt or got != acts
               or len(self.stats) != n_heavy * S)
        for i, (p_x, p_y) in enumerate(self.stats):
            bad |= int(p_x.sum()) != subpx[i % S] or abs(p_y.sum() - 1) > 1e-3
        log(f"[train] heavy summaries (--log_train_heavy "
            f"{TRAIN_HEAVY_EVERY}, {n_heavy} steps): {len(self.tags['image'])}"
            f" images, {len(self.tags['histogram'])} symbol histograms, "
            f"activation counts {got} (expected {acts}), {len(self.stats)} "
            f"p_x / p_y pairs (ps_figure's inputs, recorded in its place); "
            f"{[round(m, 1) for m in self.ms]} ms a heavy step | {card}")
        if bad:
            raise RuntimeError(f"heavy summaries: tags {self.tags}")


def conv_determinism(net, batch):
    """numerics_guard's deterministic cuDNN on every convolution of `net`
    in its compute dtype: a training forward and backward run twice on
    `batch` must give every conv's output and every parameter's gradient
    bit for bit; raises naming the first conv that differs."""
    outs = [{}, {}]
    convs = [(n, m) for n, m in net.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    for run in range(2):
        hooks = [m.register_forward_hook(
            lambda m_, i_, o_, n_=n: outs[run].__setitem__(n_, o_.detach()))
            for n, m in convs]
        net.zero_grad(set_to_none=True)
        out = net(torch.from_numpy(batch).cuda().float(), train=True)
        loss = blueprint.compute_loss(net.cfg, out).loss_pc
        loss.backward()
        for h in hooks:
            h.remove()
        outs[run]["grads"] = {n: m.weight.grad.clone() for n, m in convs}
    for n, m in convs:
        if not torch.equal(outs[0][n], outs[1][n]):
            raise RuntimeError(f"conv {n} ({outs[0][n].dtype}): two "
                               "forwards differ; cuDNN picked a "
                               "nondeterministic algorithm")
        if not torch.equal(outs[0]["grads"][n], outs[1]["grads"][n]):
            raise RuntimeError(f"conv {n}: two backwards give other weight "
                               "gradients; cuDNN picked a nondeterministic "
                               "algorithm")
    net.zero_grad(set_to_none=True)
    dts = sorted({str(outs[0][n].dtype) for n, _ in convs})
    log(f"[train] {len(convs)} convolutions ({', '.join(dts)}; dilated "
        f"ones included): forward outputs and weight gradients equal bit "
        f"for bit over two runs (cudnn.deterministic "
        f"{torch.backends.cudnn.deterministic}, benchmark "
        f"{torch.backends.cudnn.benchmark}, allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32})")


def profile_step(trainer, batch, step_ms):
    """Device time of one train step by kind (torch.profiler): the cuDNN
    convolutions forward and backward, K6, the optimizer, everything else
    (elementwise, reductions, copies); the host / idle share against the
    unprofiled step's time."""
    from torch.profiler import ProfilerActivity, profile
    trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    # device-side ranges of user annotations (the optimizer's step) span
    # kernels counted on their own: left out
    ev = [e for e in prof.key_averages()
          if getattr(e, "self_device_time_total", 0) > 0
          and not getattr(e, "is_user_annotation", False)
          and not e.key.startswith(("Optimizer.", "ProfilerStep"))]
    # kernels are device-type events; the host op that launched a kernel
    # carries its time again as self device time: kinds are read from the
    # ops, K6 (launched through ctypes, under no op) from its kernels
    kern = [e for e in ev if str(e.device_type).endswith("CUDA")]
    ops = [e for e in ev if not str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    kinds = {"K6": sum(e.self_device_time_total for e in kern
                       if "dmll_kernel" in e.key) / 1e3}
    for e in ops:
        k = e.key.lower()
        kind = ("convolution backward (cuDNN)" if "convolution" in k
                and "backward" in k
                else "convolution forward (cuDNN)" if "convolution" in k
                else "optimizer" if "foreach" in k or "rmsprop" in k
                else "elementwise and other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    log(f"[train] profiled step: device busy {busy:.2f} ms in "
        f"{sum(e.count for e in kern)} kernels; the unprofiled step "
        f"{step_ms:.2f} ms, so {100 * (1 - busy / step_ms):.1f}% host / idle"
        f" (profiled wall {wall:.1f} ms)")
    for kind, t in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"[train]   {kind:30s} {t:8.2f} ms ({100 * t / busy:.1f}%)")
    kern.sort(key=lambda e: -e.self_device_time_total)
    for e in kern[:8]:
        log(f"[train]   kernel {e.self_device_time_total / 1e3:8.2f} ms "
            f"{e.count:4d}x  {e.key[:80]}")


# ------------------------------------------------------------------ host

# r5b's v1 rounds: float32 on the first HOST_IMGS images, bfloat16 on one
HOST_IMGS = 2
# the v1 stages a StackTimer scope belongs to (Bitcoding's scope names)
V1_STAGES = {"forward": ("forwardpass",), "get_P": ("get_P",),
             "d2h": ("to host",), "coder": ("entropy", "uniform")}


CPUID_BRAND = r"""
#include <cpuid.h>
#include <stdio.h>
int main() {
  unsigned r[12] = {0};
  for (int i = 0; i < 3; ++i)
    __get_cpuid(0x80000002u + i, &r[4 * i], &r[4 * i + 1], &r[4 * i + 2],
                &r[4 * i + 3]);
  fwrite(r, 1, sizeof r, stdout);
  return 0;
}
"""


def host_cpu() -> str:
    """The host CPU's model name and count (the v1 coder's times are host
    times): /proc/cpuinfo's, or where a sandbox reports it unknown, the
    processor's brand string read by cpuid (a tiny g++ program)."""
    name = "unknown"
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                name = line.split(":", 1)[1].strip()
                break
    if name.lower() in ("", "unknown"):
        with tempfile.TemporaryDirectory(prefix="l3c_cpuid_") as d:
            exe = os.path.join(d, "brand")
            subprocess.run(["g++", "-x", "c++", "-", "-o", exe],
                           input=CPUID_BRAND, text=True, check=True,
                           timeout=60)
            raw = subprocess.run([exe], capture_output=True, check=True,
                                 timeout=10).stdout
        name = raw.split(b"\0")[0].decode("ascii", "replace").strip() \
            or "unknown"
        name += " (cpuid; /proc/cpuinfo says unknown)"
    return f"{name}, {os.cpu_count()} CPUs"


def v1_round(bc, img, path):
    """One format-v1 encode and decode of `img` through Bitcoding `bc`:
    (file bpsp, {side: {"ms": wall, stage: ms}}), each side's stages summed
    over its scales from a StackTimer of its own (get_P ends in a
    synchronize, so it is the card's work). Raises unless bit-exact."""
    from l3c_torch.eval.timer import StackTimer
    out = {}
    for side in ("enc", "dec"):
        bc.times = StackTimer(device=bc.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if side == "enc":
            bpsp = bc.encode(img, path)
        else:
            got = bc.decode(path)
        torch.cuda.synchronize()
        lasts = bc.times.lasts()
        st = {"ms": (time.perf_counter() - t0) * 1e3}
        for stage, keys in V1_STAGES.items():
            st[stage] = 1e3 * sum(v for k, v in lasts.items()
                                  if any(key in k for key in keys))
        out[side] = st
    if not np.array_equal(got, img):
        raise RuntimeError(f"v1 round trip of {path} is NOT bit-exact")
    return bpsp, out


def reference_state_dict(tree, cfg):
    """Flax parameters in the reference's state_dict layout (OIHW,
    Sequential index names) with the fixed MeanShift convs and the level
    tables the importer verifies: the inverse of
    l3c_torch.convert.torch_import.import_state_dict."""
    from l3c_torch.models import grids
    p = tree["params"]
    sd = {}

    def conv(key, leaf):
        sd[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(
            leaf["kernel"].transpose(3, 2, 0, 1)))
        sd[f"{key}.bias"] = torch.from_numpy(np.array(leaf["bias"]))

    def blocks(prefix, m, n):
        for i in range(n):
            conv(f"{prefix}.{i}.body.0", m[f"block{i}"]["conv1"])
            conv(f"{prefix}.{i}.body.2", m[f"block{i}"]["conv2"])

    eye = np.eye(3, dtype=np.float32).reshape(3, 3, 1, 1)
    sd["sub_rgb_mean.weight"] = torch.from_numpy(eye)
    sd["sub_rgb_mean.bias"] = torch.from_numpy(
        np.float32(-255.0) * layers.RGB_MEAN)
    sd["heads.0.head.0.weight"] = torch.from_numpy(eye / np.float32(128))
    sd["heads.0.head.0.bias"] = torch.zeros(3)
    lo, hi = cfg.q.levels_range
    nb_e, nb_d = cfg.enc.num_blocks, cfg.dec.num_blocks
    for s in range(cfg.num_scales):
        conv("heads.0.head.1.head" if s == 0 else f"heads.{s}.head",
             p[f"head{s}"]["conv"])
        e = p[f"enc{s}"]
        conv(f"nets.{s}.enc.down", e["down"])
        conv(f"nets.{s}.enc.to_q.0", e["to_q"])
        conv(f"nets.{s}.enc.body.{nb_e}", e["body_out"])
        blocks(f"nets.{s}.enc.body", e, nb_e)
        sd[f"nets.{s}.enc.levels"] = torch.from_numpy(
            grids.levels(lo, hi, cfg.q.L))
        dec = p[f"dec{s}"]
        conv(f"nets.{s}.dec.head", dec["head"])
        conv(f"nets.{s}.dec.body.{nb_d}", dec["body_out"])
        conv(f"nets.{s}.dec.tail.0", dec["tail"]["up0"])
        blocks(f"nets.{s}.dec.body", dec, nb_d)
        a = p[f"clf{s}"]["atrous"]
        conv(f"prob_clfs.{s}.atrous.lin", a["lin"])
        for i in range(len(a) - 1):
            conv(f"prob_clfs.{s}.atrous.atrous.{i}", a[f"atrous{i}"])
    return sd


def phase_host(cfg, net, imgs, theory_bpsp, card, resumed_dir, cr_rgb):
    """The host codec (format v1) and the host tools on the card machine,
    through the entry points a user calls: r5b through Bitcoding (float32
    on HOST_IMGS images, bfloat16 on one; bit-exact, per-stage times,
    file bpsp against theory and against v8's, the device-busy share of a
    round) and the pack stage's time against its bound; cli.l3c enc/dec
    and cli.test --write_to_files with --codec_backend host, and a v8 file
    through the same dispatch; phase baselines' cr_rgb through the host
    backend (unit 0 at L = 256 under the uniform coder); r5b written in
    the reference's .pt layout, converted by cli.convert (every leaf equal
    to r5b's, the same theory bpsp through cli.test); SWA over phase
    train's resumed run (it restores and codes); cli.classic --no_png over
    the 8 PNGs. Every call's launch counts are exactly its path's: v1 and
    the host tools launch none of the kernels."""
    from l3c_torch.cli import classic as classic_cli
    from l3c_torch.cli import convert as convert_cli
    from l3c_torch.codec.bitcoding import Bitcoding
    from l3c_torch.models.weights import (_flatten, read_checkpoint,
                                         restore_params_only)
    from l3c_torch.tools import swa
    cpu = host_cpu()
    roots = l3c_cli.default_config_roots()
    total = {}
    with tempfile.TemporaryDirectory(prefix="l3c_host_") as d:
        # ---- r5b through Bitcoding on the card
        for dtype, n in (("float32", HOST_IMGS), ("bfloat16", 1)):
            c, m = (cfg, net) if dtype == "float32" else with_dtype(
                cfg, net, dtype)
            bc = Bitcoding(c, m, device="cuda")
            v8 = TorchBitcoding(c, m, device="cuda", coder_profile="size")
            v1_round(bc, imgs[0], os.path.join(d, f"warm_{dtype}.l3c"))
            for i in range(n):
                p1 = os.path.join(d, f"{dtype}{i}.l3c")
                bpsp, st = counted(total, f"v1 round ({dtype}, image {i})",
                                   lambda: v1_round(bc, imgs[i], p1), {})
                with torch.inference_mode():
                    x = torch.from_numpy(imgs[i]).cuda().float()
                    th = float(blueprint.total_bpsp(
                        blueprint.compute_loss(c, m(x))))
                p8 = os.path.join(d, f"{dtype}{i}_v8.l3c")
                b8 = v8.encode(imgs[i], p8)
                if not np.array_equal(v8.decode(p8), imgs[i]):
                    raise RuntimeError("v8 size-profile round not bit-exact")
                wall = st["enc"]["ms"] + st["dec"]["ms"]
                fmt = lambda s: ", ".join(f"{k} {v:.1f}" for k, v in s.items())
                log(f"[host] r5b v1 {dtype} image {i} ({SZ}x{SZ}) bit-exact: "
                    f"file bpsp {bpsp:.6f} vs theory {th:.6f} "
                    f"({100 * (bpsp / th - 1):+.2f}%) vs v8 size profile "
                    f"{b8:.6f} | enc ms: {fmt(st['enc'])} | dec ms: "
                    f"{fmt(st['dec'])} | {SZ * SZ / 1e3 / wall:.4f} MP/s "
                    f"enc+dec | {card} | host {cpu}")
            p2 = os.path.join(d, f"busy_{dtype}.l3c")
            kern, copies = device_busy_split_ms(
                lambda: (bc.encode(imgs[0], p2), bc.decode(p2)))
            log(f"[host] r5b v1 {dtype}: device busy {kern + copies:.1f} ms "
                f"of the round's {wall:.1f} ms = "
                f"{100 * (kern + copies) / wall:.1f}% (torch.profiler): "
                f"kernels {kern:.1f} ms, copies {copies:.1f} ms | {card}")
            if dtype == "float32":
                with torch.inference_mode():
                    l0 = m(torch.from_numpy(imgs[0]).cuda().float()).P[0]
                    out = bc.pack(0, l0)
                    ms = cuda_ms(lambda: bc.pack(0, l0))
                # l read once, the four arrays written once; an exp a
                # softmax and inv_s entry, an exp and a division a lambda
                nbytes = 4 * (l0.numel() + sum(a.numel() for a in out))
                b = bound(nbytes, OPS_EXP * (out[0].numel() + out[2].numel()
                                             + 2 * out[3].numel()))
                log(f"[host] stage dmll.pack_coder_params + (C,HW,K) layout "
                    f"on r5b's scale 0, l {tuple(l0.shape)}: {ms:.4f} ms vs "
                    f"bound {b[0]:.4f} ms ({b[1]}) | {card}")
                # what the copy to the host costs: the codec's pageable
                # .cpu() against the same bytes into pinned buffers
                pinned = [torch.empty(a.shape, pin_memory=True) for a in out]

                def host_ms(copy):
                    times = []
                    for _ in range(4):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        copy()
                        torch.cuda.synchronize()
                        times.append((time.perf_counter() - t0) * 1e3)
                    return statistics.median(times[1:])
                pg = host_ms(lambda: [a.cpu() for a in out])
                pn = host_ms(lambda: [h.copy_(a) for h, a in zip(pinned,
                                                                 out)])
                mb = 4 * sum(a.numel() for a in out) / 1e6
                log(f"[host] scale 0's packed parameters to the host "
                    f"({mb:.1f} MB): pageable .cpu() {pg:.2f} ms = "
                    f"{mb / pg:.2f} GB/s; into pinned buffers {pn:.2f} ms = "
                    f"{mb / pn:.2f} GB/s (median of 3 after one) | {card} | "
                    f"host {cpu}")
                del l0, out, pinned
            del bc, v8, m
        # ---- the CLIs with --codec_backend host, and v8 through dispatch
        img_dir = os.path.join(d, "imgs")
        two_dir = os.path.join(d, "two")
        os.makedirs(img_dir)
        os.makedirs(two_dir)
        for b, im in enumerate(imgs):
            write_png(os.path.join(img_dir, f"im{b}.png"), im[0])
            if b < 2:
                write_png(os.path.join(two_dir, f"im{b}.png"), im[0])
        src = os.path.join(img_dir, "im0.png")
        for backend, version, enc_l, dec_l in (
                ("host", 2, ({},), ({},)),
                ("auto", 8, (ENCODE, CANARY), (DECODE, CANARY))):
            coded = os.path.join(d, f"cli_{backend}.l3c")
            back = os.path.join(d, f"cli_{backend}.png")
            t0 = time.perf_counter()
            counted(total, f"cli.l3c enc --codec_backend {backend}",
                    lambda: run_cli(l3c_cli.main, [
                        ZOO, LOG_DATE, "enc", src, coded, "--codec_backend",
                        backend]), *enc_l)
            t1 = time.perf_counter()
            counted(total, f"cli.l3c dec of a v{version} file",
                    lambda: run_cli(l3c_cli.main, [
                        ZOO, LOG_DATE, "dec", coded, back]), *dec_l)
            t2 = time.perf_counter()
            with open(coded, "rb") as f:
                head = f.read(5)
            if head[4] != version or not np.array_equal(read_png(back),
                                                        imgs[0][0]):
                raise RuntimeError(f"cli.l3c --codec_backend {backend}: "
                                   f"version {head[4]} or pixels wrong")
            log(f"[host] cli.l3c enc --codec_backend {backend} -> format "
                f"byte {version}, dec through the version dispatch: "
                f"bit-exact, enc {1e3 * (t1 - t0):.0f} ms dec "
                f"{1e3 * (t2 - t1):.0f} ms (checkpoint load included)")
        out_dir, rep = os.path.join(d, "out"), os.path.join(d, "times.txt")
        out = counted(total, "cli.test --write_to_files --codec_backend "
                      "host", lambda: run_cli(test_cli.main, [
                          ZOO, LOG_DATE, two_dir, "--write_to_files",
                          out_dir, "--codec_backend", "host",
                          "--time_report", rep, "--reset_cache"]), {})
        sizes = []
        for b in range(2):
            with open(os.path.join(out_dir, f"im{b}.l3c"), "rb") as f:
                blob = f.read()
            if blob[4] != 2:
                raise RuntimeError("cli.test --codec_backend host wrote "
                                   f"format byte {blob[4]}")
            sizes.append(len(blob))
        shown = float(out.strip().splitlines()[-1].split()[-1])
        file_bpsp = float(np.mean(sizes)) * 8 / imgs[0].size
        if f"{file_bpsp:.4f}" != f"{shown:.4f}":
            raise RuntimeError("cli.test --codec_backend host: the table "
                               "does not show the files' bpsp")
        log(f"[host] cli.test --write_to_files --codec_backend host: 2 "
            f"files bit-exact (the tester's gate), file bpsp "
            f"{file_bpsp:.6f}; time report "
            f"{open(rep).read().strip().replace(chr(10), '; ')}")
        # ---- phase baselines' cr_rgb through the host backend
        root, date = cr_rgb
        coded, back = os.path.join(d, "cr_rgb.l3c"), os.path.join(
            d, "cr_rgb.png")
        t0 = time.perf_counter()
        counted(total, "cli.l3c enc --codec_backend host (cr_rgb)",
                lambda: run_cli(l3c_cli.main, [root, date, "enc", src, coded,
                                               "--codec_backend", "host"]),
                {})
        counted(total, "cli.l3c dec (cr_rgb, v1)", lambda: run_cli(
            l3c_cli.main, [root, date, "dec", coded, back]), {})
        if not np.array_equal(read_png(back), imgs[0][0]):
            raise RuntimeError("cr_rgb v1 round trip is NOT bit-exact")
        cli_s = time.perf_counter() - t0
        tester = MultiscaleTester.from_log_dir(find_log_dir(root, date),
                                               roots, use_cache=False)
        bc = Bitcoding(tester.cfg, tester.net, device="cuda")
        v1_round(bc, imgs[0], os.path.join(d, "cr_rgb_warm.l3c"))
        bpsp, st = counted(total, "v1 round (cr_rgb)", lambda: v1_round(
            bc, imgs[0], os.path.join(d, "cr_rgb_timed.l3c")), {})
        if bpsp != os.path.getsize(coded) * 8 / imgs[0].size:
            raise RuntimeError("cr_rgb: the CLI's v1 file differs in size")
        fmt = lambda s: ", ".join(f"{k} {v:.1f}" for k, v in s.items())
        log(f"[host] cr_rgb (phase baselines) v1 round of one {SZ}x{SZ} "
            f"image bit-exact through cli.l3c ({cli_s:.1f} s with two "
            f"checkpoint loads) and Bitcoding: file bpsp {bpsp:.6f} (unit 0 "
            f"at L = 256 under UniformCoder) | enc ms: {fmt(st['enc'])} | "
            f"dec ms: {fmt(st['dec'])} | {card} | host {cpu}")
        del bc, tester
        # ---- convert: r5b in the reference's .pt layout -> cli.convert
        r5b = read_checkpoint(CKPT)["params"]
        pt = os.path.join(d, "ckpt_0000246250.pt")
        torch.save({"net": reference_state_dict(r5b, cfg)}, pt)
        conv_root = os.path.join(d, "converted")
        counted(total, "cli.convert", lambda: run_cli(convert_cli.main, [
            pt, os.path.join(roots[0], "ms", "cr.cf"), conv_root]), {})
        (name,) = os.listdir(conv_root)
        got = _flatten(read_checkpoint(os.path.join(
            conv_root, name, "ckpts", "ckpt_0000246250.ckpt"))["params"])
        want = _flatten(r5b)
        same = got.keys() == want.keys() and all(
            got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            and got[k].tobytes() == want[k].tobytes() for k in want)
        if not same:
            raise RuntimeError("the converted parameters differ from r5b's")
        out = counted(total, "cli.test (converted r5b)", lambda: run_cli(
            test_cli.main, [conv_root, name.split()[0], img_dir,
                            "--reset_cache"]), THEORY)
        shown = out.strip().splitlines()[-1].split()[-1]
        zoo = MultiscaleTester.from_log_dir(
            find_log_dir(ZOO, LOG_DATE), roots, use_cache=False).test(
                Testset(img_dir)).mean_bpsp()
        conv = MultiscaleTester.from_log_dir(
            os.path.join(conv_root, name), roots, use_cache=False).test(
                Testset(img_dir)).mean_bpsp()
        rel = abs(conv - theory_bpsp) / theory_bpsp
        log(f"[host] cli.convert of r5b in the reference's .pt layout "
            f"({name}): {len(got)} leaves bitwise equal to r5b's; theory "
            f"bpsp of the 8 images {conv:.6f} (table {shown}) = r5b's "
            f"{zoo:.6f}: {conv == zoo}; vs phase forward {theory_bpsp:.6f} "
            f"rel {rel:.2e}")
        if conv != zoo or rel > 1e-5 or shown != f"{conv:.4f}":
            raise RuntimeError("the converted r5b's theory bpsp differs")
        # ---- SWA over phase train's resumed run
        persistent = sorted(f for f in os.listdir(os.path.join(
            resumed_dir, "ckpts")) if f.endswith(".ckpt"))
        swa_dir = os.path.join(d, "swa", "0909_0909 cr oi_offline swa")
        t0 = time.perf_counter()
        counted(total, "tools.swa", lambda: run_cli(swa.main, [
            resumed_dir, swa_dir, "--last", str(len(persistent))]), {})
        swa_s = time.perf_counter() - t0
        itr, sd = restore_params_only(swa_dir)
        check = MultiscaleNetwork(cfg)
        check.load_state_dict(sd, strict=True)
        leaves = [_flatten(read_checkpoint(os.path.join(
            resumed_dir, "ckpts", f))["params"]) for f in persistent]
        key = "params.clf0.atrous.lin.kernel"
        mean = (np.sum([lv[key].astype(np.float64) for lv in leaves], 0)
                / len(leaves)).astype(np.float32)
        if not np.array_equal(_flatten(read_checkpoint(os.path.join(
                swa_dir, "ckpts", f"ckpt_{itr:010d}.ckpt"))["params"])[key],
                mean):
            raise RuntimeError("SWA's leaf is not the checkpoints' mean")
        coded, back = os.path.join(d, "swa.l3c"), os.path.join(d, "swa.png")
        root = os.path.dirname(swa_dir)
        counted(total, "cli.l3c enc (SWA)", lambda: run_cli(
            l3c_cli.main, [root, "0909", "enc", src, coded]), ENCODE, CANARY)
        counted(total, "cli.l3c dec (SWA)", lambda: run_cli(
            l3c_cli.main, [root, "0909", "dec", coded, back]), DECODE, CANARY)
        if not np.array_equal(read_png(back), imgs[0][0]):
            raise RuntimeError("the SWA checkpoint did not code bit-exactly")
        log(f"[host] tools.swa over the resumed run's {len(persistent)} "
            f"persistent checkpoints ({persistent[0]}..{persistent[-1]}) in "
            f"{swa_s:.2f} s: restores strictly at itr {itr}; one {SZ}x{SZ} "
            f"image through cli.l3c (v8) bit-exact, file bpsp "
            f"{os.path.getsize(coded) * 8 / imgs[0].size:.6f}")
        # ---- the classical anchor
        out = counted(total, "cli.classic --no_png", lambda: run_cli(
            classic_cli.main, ["--no_png", img_dir]), {})
        log(f"[host] cli.classic --no_png over the {B} PNGs (each round trip "
            f"asserted): {out.strip().split(': ', 1)[1]} | host {cpu}")
    log(f"[host] launches on this phase, all calls: "
        f"{ {k: v for k, v in total.items() if v} }")


# ------------------------------------------------------------- parallel

# phase parallel: steps of the world-1 NCCL rank (phase train's resumed
# float32 recipe) and of the two gloo ranks (r5b at its final lr); the
# spatial image's height and halo, the second pair run only when the first
# misses the gate (r5b's receptive field would then exceed 512 rows); the
# halos whose gap to the unsharded forward is printed beside
PAR_STEPS_W1, PAR_STEPS_W2, PAR_LR_W2 = 5, 3, 5e-6
PAR_SPATIAL = ((2048, 512), (4096, 1024))
PAR_HALOS = (128, 256)
PAR_STEP = {"dmll_nll": 3, "dmll_nll_grad": 3}
# the world-1 rank: cli.train with its train_step recorded (loss, host ms
# around a synchronised step, the rank's world, wrapper and backend), the
# kernel launches of the run, all written to the JSON file argv[1] names
DDP_CHILD = r"""
import json, sys, time
import torch
import torch.distributed as dist
from l3c_torch.cli import train as train_cli
from l3c_torch.ops import kernels
from l3c_torch.train.trainer import Trainer
seen = {"losses": [], "ms": []}
step = Trainer.train_step
def run(self, batch):
    if self.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = step(self, batch)
    seen["losses"].append(float(m["loss_bpsp"]))
    seen["ms"].append((time.perf_counter() - t0) * 1e3)
    seen.update(world=self.world, ddp=type(self._dp).__name__,
                backend=dist.get_backend())
    return m
Trainer.train_step = run
kernels.reset_launches()
rc = train_cli.main(sys.argv[2:])
seen["launches"] = dict(kernels.launches)
with open(sys.argv[1], "w") as f:
    json.dump(seen, f)
sys.exit(rc)
"""


def flat_leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flat_leaves(tree[k], f"{path}/{k}")]
    return [(path, np.asarray(tree))]


def within(got, want, rtol, atol) -> Tuple[bool, float]:
    """(every leaf within atol + rtol |want|, the largest |got - want|)."""
    ok, worst = True, 0.0
    for (pa, a), (pb, b) in zip(flat_leaves(got), flat_leaves(want)):
        if pa != pb or a.shape != b.shape:
            return False, math.inf
        d = np.abs(a.astype(np.float64) - b)
        ok = ok and bool((d <= atol + rtol * np.abs(b)).all())
        worst = max(worst, float(d.max()))
    return ok, worst


def phase_parallel(cfg, net, bc, imgs, round_ms, card, resumed_dir,
                   resumed_losses, dev="cuda:0"):
    """The parallel paths (l3c_torch/parallel) on one card, two slots or
    ranks on it where a path has several: cli.train as one NCCL rank under
    the L3C_* variables (phase train's losses bit for bit, its checkpoint);
    two gloo ranks on one card against the single-process Trainer (JAX's DP
    tolerances, 3 + 3 K6 launches a rank a step); CodecFanout over two
    slots (bit-exact, each file byte-identical to bc's, exact launches,
    none of the plain versions on the card; mixed device kinds refused);
    eval_testset_sharded (8 images and a ragged 3) against the per-image
    single-device mean; spatial_bpsp with two slabs against one; cli.test
    --spatial_shard and --write_to_files --fanout with two slots. Returns
    the launches of the phase's runs by kernel."""
    from l3c_torch.data.images import TrainBatches
    from l3c_torch.models.weights import params_to_jax, read_checkpoint
    from l3c_torch.parallel import fanout, mesh, spatial
    from l3c_torch.train.trainer import Trainer
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    slots = [torch.device(dev)] * 2
    ms_cf = os.path.join(l3c_cli.default_config_roots()[0], "ms", "cr.cf")
    dl_cf = os.path.join(l3c_cli.default_config_roots()[0], "dl",
                         "oi_offline.cf")
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="l3c_par_") as d:
        # ---- DDP, world 1 over NCCL: cli.train in a subprocess, this
        # process the coordinator's host
        train_dir, val_dir = train_pngs(d)
        root = os.path.join(d, "logs")
        os.makedirs(root)
        zoo_dir = os.path.dirname(os.path.dirname(CKPT))
        os.symlink(zoo_dir, os.path.join(root, os.path.basename(zoo_dir)))
        argv = [ms_cf, dl_cf, root, "-p", f"dl.train_imgs_glob='{train_dir}'",
                "-p", f"dl.val_glob='{val_dir}'", "-p",
                "dl.image_cache_pkl=None", "-p", "lr.schedule='none'",
                "--restore", LOG_DATE, "--num_itr", str(PAR_STEPS_W1),
                "--log_train", "1", "--log_val", "0", "--keep_tmp_itr",
                str(PAR_STEPS_W1), "--keep_every", "1"]
        if not cuda:
            argv += ["--device", "cpu"]
        got_json = os.path.join(d, "w1.json")
        env = dict(os.environ, L3C_NUM_PROCS="1", L3C_PROC_ID="0",
                   L3C_COORDINATOR=f"127.0.0.1:{mesh.free_port()}")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", DDP_CHILD, got_json,
                              *argv], cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        w1_s = time.perf_counter() - t0
        for line in run.stdout.splitlines():
            log(f"[parallel]   w1 | {line}")
        if run.returncode:
            log(run.stderr[-6000:])
            raise RuntimeError(f"the world-1 rank exited {run.returncode}")
        with open(got_json) as f:
            w1 = json.load(f)
        end = 246250 + PAR_STEPS_W1
        name = f"ckpt_{end:010d}.ckpt"
        (new,) = [n for n in os.listdir(root) if not n.startswith(LOG_DATE)]
        ddp_ck = read_checkpoint(os.path.join(root, new, "ckpts", name))
        one_ck = read_checkpoint(os.path.join(resumed_dir, "ckpts", name))
        names_eq = ([p for p, _ in flat_leaves(ddp_ck)]
                    == [p for p, _ in flat_leaves(one_ck)])
        n_diff = sum(not np.array_equal(a, b) for (_, a), (_, b) in zip(
            flat_leaves(ddp_ck), flat_leaves(one_ck)))
        want = {k: PAR_STEPS_W1 * v for k, v in PAR_STEP.items()}
        launches = {k: v for k, v in w1["launches"].items() if v}
        log(f"[parallel] DDP world 1 ({w1['ddp']}, backend {w1['backend']},"
            f" world {w1['world']}): cli.train under L3C_* resumed r5b "
            f"{PAR_STEPS_W1} steps in {w1_s:.1f} s: losses {w1['losses']} vs "
            f"phase train's {resumed_losses[:PAR_STEPS_W1]} (equal: "
            f"{w1['losses'] == resumed_losses[:PAR_STEPS_W1]}); step ms "
            f"{[round(v, 2) for v in w1['ms']]}; {name}: leaf names equal "
            f"{names_eq}, {n_diff} leaves differ from phase train's; "
            f"launches {launches} (expected {want}) | {card}")
        if (w1["world"], w1["ddp"], w1["backend"]) != (
                1, "DistributedDataParallel", mesh.backend_for(dev)):
            raise RuntimeError("the world-1 run did not train under DDP")
        if w1["losses"] != resumed_losses[:PAR_STEPS_W1]:
            raise RuntimeError("world-1 DDP losses differ from phase train's")
        if not names_eq or n_diff or launches != want:
            raise RuntimeError("world-1 DDP checkpoint or launches wrong")
        add(launches)

        # ---- DDP, world 2 over gloo, both ranks on one card, against the
        # single-process Trainer on the whole batch
        dl = load_dl_config(dl_cf)
        tb = TrainBatches(sorted(os.path.join(train_dir, f)
                                 for f in os.listdir(train_dir)),
                          dl.batchsize_train, dl.crop_size, seed=0,
                          aug_strong=dl.aug_strong)
        it = iter(tb)
        batches = [next(it) for _ in range(PAR_STEPS_W2)]
        tb.close()
        cfg2 = dataclasses.replace(cfg, lr_initial=PAR_LR_W2,
                                   lr_schedule="none")
        state = read_checkpoint(CKPT)
        ref = Trainer(cfg2, dl, MultiscaleNetwork(cfg2), [], epoch_len=10,
                      device=dev)
        ref.load_state_tree(state)
        ref_losses, ref_params, ref_ms = [], [], []
        for b in batches:
            sync()
            t0 = time.perf_counter()
            ref_losses.append(float(ref.train_step(b)["loss_bpsp"]))
            ref_ms.append((time.perf_counter() - t0) * 1e3)
            ref_params.append(params_to_jax(
                {k: v.clone() for k, v in ref.net.state_dict().items()}))
        del ref
        t0 = time.perf_counter()
        ranks = mesh.spawn(mesh.train_steps, 2, "gloo", slots,
                           (cfg2, dl, state, batches), timeout=600)
        w2_s = time.perf_counter() - t0
        want = {k: PAR_STEPS_W2 * v for k, v in PAR_STEP.items()}
        worst, bad = 0.0, []
        for r, rk in enumerate(ranks):
            launches = {k: v for k, v in rk["launches"].items() if v}
            if launches != want:
                bad.append(f"rank {r} launched {launches}")
            add(launches)
            for s_, (lo, want_lo) in enumerate(zip(rk["losses"],
                                                   ref_losses)):
                if abs(lo - want_lo) > 1e-5 * abs(want_lo):
                    bad.append(f"rank {r} step {s_} loss {lo} vs {want_lo}")
            for s_, (p, want_p) in enumerate(zip(rk["params"], ref_params)):
                ok, w = within(p, want_p, 2e-4, 2e-6)
                worst = max(worst, w)
                if not ok:
                    bad.append(f"rank {r} step {s_}: parameters beyond "
                               f"rtol 2e-4 / atol 2e-6 (max |diff| {w:.3e})")
        same = all(np.array_equal(a, b) for p0, p1 in zip(
            ranks[0]["params"], ranks[1]["params"]) for (_, a), (_, b) in zip(
                flat_leaves(p0), flat_leaves(p1)))
        log(f"[parallel] DDP world 2 (gloo, both ranks on {dev}), r5b at lr "
            f"{PAR_LR_W2:g}, {PAR_STEPS_W2} steps of {dl.batchsize_train} x "
            f"{dl.crop_size}^2 in {w2_s:.1f} s: losses "
            f"{ranks[0]['losses']} vs the single process's {ref_losses}; "
            f"parameters' max |diff| {worst:.3e}; the ranks' replicas equal: "
            f"{same}; step ms rank 0 {[round(v, 2) for v in ranks[0]['ms']]}"
            f" rank 1 {[round(v, 2) for v in ranks[1]['ms']]} single process "
            f"{[round(v, 2) for v in ref_ms]} | {card}")
        if bad or not same:
            raise RuntimeError(f"world-2 DDP: {bad or 'replicas differ'}")
        del ranks, ref_params, state

        # ---- the codec fan-out: two slots, 16 images, groups of B
        imgs16 = list(imgs) + bench_images(seed=1)
        fo = fanout.CodecFanout(cfg, net, slots, group=B,
                                coder_profile="balanced", coder_topk=4)
        rot = fanout.CodecFanout(cfg, net, slots[1:] + slots[:1], group=B,
                                 coder_profile="balanced", coder_topk=4)
        used = set()
        for tag, f, meth in (("enc", fo, "encode_batch_async"),
                             ("dec", rot, "decode_batch_async")):
            for k, c in enumerate(f.codecs):
                c.canary(c.coder_topk)       # headers' canaries: not counted
                setattr(c, meth, lambda *a, _o=getattr(c, meth), _k=(tag, k):
                        (used.add(_k), _o(*a))[1])
        paths = [os.path.join(d, f"fan{i}.l3c") for i in range(len(imgs16))]
        plain_calls = {name: 0 for name in INT_CODER_ROWS + PLAIN_PACK}
        restore = count_cuda_calls(int_coder, INT_CODER_ROWS + PLAIN_PACK,
                                   plain_calls)
        try:
            kernels.reset_launches()
            sync()
            t0 = time.perf_counter()
            bpsps = fo.encode_paths(imgs16, paths)
            t1 = time.perf_counter()
            outs = rot.decode_paths(paths)
            sync()
            t2 = time.perf_counter()
            fan = {k: v for k, v in kernels.launches.items() if v}
        finally:
            restore()
        add(fan)
        exact = all(np.array_equal(o, im) for o, im in zip(outs, imgs16))
        same_files = True
        for g in range(len(imgs16) // B):
            one = [os.path.join(d, f"one{g}_{b}.l3c") for b in range(B)]
            bc.encode_batch(imgs16[g * B: (g + 1) * B], one)
            same_files &= all(
                open(a, "rb").read() == open(paths[g * B + b], "rb").read()
                for b, a in enumerate(one))
        try:
            fanout.CodecFanout(cfg, net, ["cpu", "cuda:0"])
            mixed = "accepted"
        except ValueError as e:
            mixed = f"refused ({e})"
        n_groups = len(imgs16) // B          # an encode and a decode each
        want = {k: n_groups * (ENCODE.get(k, 0) + DECODE.get(k, 0))
                for k in {**ENCODE, **DECODE}}
        mp16 = len(imgs16) * SZ * SZ / 1e6
        log(f"[parallel] fan-out over 2 slots on {dev}, {len(imgs16)} x "
            f"{SZ}^2 in groups of {B} (balanced, top-4): bit-exact {exact}, "
            f"files byte-identical to one codec's {same_files}, slots used "
            f"{sorted(used)}; launches {fan} (expected {want}); plain "
            f"row/lookup/pack calls on CUDA tensors {plain_calls}; enc "
            f"{(t1 - t0) * 1e3:.1f} ms dec {(t2 - t1) * 1e3:.1f} ms = "
            f"{mp16 / (t2 - t0):.3f} MP/s enc+dec (phase codec's synchronous"
            f" round {B * SZ * SZ / 1e6 / (round_ms / 1e3):.3f} MP/s); "
            f"mean file bpsp {np.mean(bpsps):.6f}; mixed cpu + cuda:0 slots "
            f"{mixed} | {card}")
        if not (exact and same_files) or fan != want or \
                any(plain_calls.values()) or mixed == "accepted" or \
                used != {(t, k) for t in ("enc", "dec") for k in (0, 1)}:
            raise RuntimeError("the codec fan-out failed its gates")
        del fo, rot

        # ---- sharded eval: the 8 and a ragged 3 (the seed-1 images)
        with torch.inference_mode():
            singles = []
            for im in imgs16[:B + 3]:
                out = net(torch.from_numpy(im).to(dev).float())
                singles.append(float(blueprint.total_bpsp(
                    blueprint.compute_loss(cfg, out))))
        for label, crops, want_b in (
                (f"{B} images", [im[0] for im in imgs16[:B]],
                 np.mean(singles[:B])),
                ("a ragged 3", [im[0] for im in imgs16[B:B + 3]],
                 np.mean(singles[B:]))):
            n_fwd = 2 * math.ceil(len(crops) / 2)     # dummies run too
            got = counted(total, f"eval_testset_sharded, {label}",
                          lambda: fanout.eval_testset_sharded(
                              cfg, net, slots, crops),
                          {"dmll_nll": cfg.num_scales * n_fwd})
            rel = abs(got - want_b) / want_b
            log(f"[parallel] eval_testset_sharded over 2 slots, {label}: "
                f"{got:.7f} vs the per-image single-device mean "
                f"{want_b:.7f} (rel {rel:.2e})")
            if rel > 1e-5:
                raise RuntimeError("sharded eval differs from the per-image "
                                   "mean")

        # ---- spatial: two slabs against one, the same halo
        fwd = {"dmll_nll": cfg.num_scales}
        for H, halo in PAR_SPATIAL:
            img = bench_images(seed=2, n=1, H=H)[0]
            two = counted(total, f"spatial_bpsp 2 slabs, halo {halo}",
                          lambda: spatial.spatial_bpsp(cfg, net, slots, img,
                                                       halo), fwd, fwd)
            one = counted(total, f"spatial_bpsp 1 slab, halo {halo}",
                          lambda: spatial.spatial_bpsp(cfg, net, slots[:1],
                                                       img, halo), fwd)
            rel = abs(two - one) / one
            log(f"[parallel] spatial {H}x{SZ}, halo {halo}: 2 slabs "
                f"{two:.7f} vs 1 slab {one:.7f} (rel {rel:.2e})")
            if rel <= 1e-4:
                break
            log(f"[parallel] FINDING: at halo {halo} two slabs miss one "
                f"slab's bpsp by {rel:.2e} > 1e-4: r5b's receptive field "
                f"exceeds {halo} rows")
        else:
            raise RuntimeError("spatial sharding: two slabs differ from one "
                               "at every halo tried")
        with torch.inference_mode():
            full = float(blueprint.total_bpsp(blueprint.compute_loss(
                cfg, net(torch.from_numpy(img).to(dev).float()))))
        for h in sorted(set(PAR_HALOS + (halo,))):
            spatial.spatial_bpsp(cfg, net, slots, img, h)   # cuDNN's first
            sync()
            t0 = time.perf_counter()
            b = spatial.spatial_bpsp(cfg, net, slots, img, h)
            t_ms = (time.perf_counter() - t0) * 1e3
            log(f"[parallel] spatial {H}x{SZ} over 2 slabs, halo {h}: "
                f"{b:.7f}, {100 * (b / full - 1):+.4f} % against the "
                f"unsharded forward's {full:.7f}; {t_ms:.1f} ms (warm) | "
                f"{card}")

        # ---- the CLIs with two slots on the card
        cli_dir, img_dir = os.path.join(d, "cli"), os.path.join(d, "imgs8")
        os.makedirs(cli_dir)
        os.makedirs(img_dir)
        big = bench_images(seed=2, n=1, H=2 * SZ)[0][0]
        write_png(os.path.join(cli_dir, "big.png"), big)
        write_png(os.path.join(cli_dir, "im0.png"), imgs[0][0])
        for b, im in enumerate(imgs):
            write_png(os.path.join(img_dir, f"im{b}.png"), im[0])
        cache_keys = []

        def record_cache(orig):
            def run_(self, img_):
                out_ = orig(self, img_)
                cache_keys.append(sorted(self._spatial_cache))
                return out_
            return run_

        old = os.environ.get("AC_NEEDS_CROP_DIM")
        os.environ["AC_NEEDS_CROP_DIM"] = f"{SZ},{SZ}"   # big.png needs it
        try:
            with patched(mesh, "local_devices",
                         lambda orig: lambda device=None: slots), \
                    patched(MultiscaleTester, "_spatial_bpsp", record_cache):
                S = cfg.num_scales
                sp = counted(total, "cli.test --spatial_shard", lambda: run_cli(
                    test_cli.main, [ZOO, LOG_DATE, cli_dir, "--reset_cache",
                                    "--spatial_shard"]),
                    {"dmll_nll": 2 * S + S})
                ac = counted(total, "cli.test (auto-crop)", lambda: run_cli(
                    test_cli.main, [ZOO, LOG_DATE, cli_dir, "--reset_cache"]),
                    {"dmll_nll": 4 * S + S})
                outs = {}
                for tag, extra, canaries in (("plain", [], [CANARY]),
                                             ("fan", ["--fanout"],
                                              [CANARY, CANARY])):
                    out_dir = os.path.join(d, f"w2f_{tag}")
                    counted(total, f"cli.test --write_to_files {' '.join(extra)}",
                            lambda: run_cli(test_cli.main, [
                                ZOO, LOG_DATE, img_dir, "--write_to_files",
                                out_dir, "--eval_batch", str(B // 2),
                                "--reset_cache", *extra]),
                            ENCODE, ENCODE, DECODE, DECODE, *canaries)
                    outs[tag] = [open(os.path.join(out_dir, f"im{b}.l3c"),
                                      "rb").read() for b in range(B)]
        finally:
            if old is None:
                os.environ.pop("AC_NEEDS_CROP_DIM")
            else:
                os.environ["AC_NEEDS_CROP_DIM"] = old
        b_sp = float(sp.strip().splitlines()[-1].split()[-1])
        b_ac = float(ac.strip().splitlines()[-1].split()[-1])
        log(f"[parallel] cli.test --spatial_shard over 2 slots: {b_sp:.4f} "
            f"vs auto-crop {b_ac:.4f} (rel {abs(b_sp - b_ac) / b_ac:.2e}); "
            f"the tester's cache {cache_keys}; cli.test --write_to_files "
            f"--fanout (groups of {B // 2} over 2 slots): bit-exact, files "
            f"byte-identical to the run without --fanout "
            f"{outs['fan'] == outs['plain']}")
        if abs(b_sp - b_ac) > 0.05 * b_ac or cache_keys != [[(2 * SZ, SZ)]] \
                or outs["fan"] != outs["plain"]:
            raise RuntimeError("the CLIs' parallel paths failed their gates")
    log(f"[parallel] launches in this phase, all runs: {total}")
    return total


# ------------------------------------------------------------------ prep

PREP_FIXTURES = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "prep")
PREP_STEPS = 5
# a step's 3 + 3 K6 launches, and the validation at step 5: num_val_batches
# (2) forwards of 3 scales
PREP_TRAIN = {"dmll_nll": PREP_STEPS * 3 + 2 * 3,
              "dmll_nll_grad": PREP_STEPS * 3}
PREP_RATE = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "rate")
PREP_RATE_COPIES = 32           # the rate fixture repeated for --inp_dir
PREP_RATE_MIN_RES = 512         # prep's default, as users run it
# prep_pipeline --inp_dir in a fresh process, as a user runs it, its
# import and its work timed apart
PREP_RATE_SCRIPT = """
import json, sys, time
t0 = time.perf_counter()
from l3c_torch.cli import prep_pipeline
from l3c_torch.data import images, prep, resample  # what main() reaches
t1 = time.perf_counter()
prep_pipeline.main(["--inp_dir", sys.argv[1], sys.argv[2], "--min_res",
                    sys.argv[3], "--workers", sys.argv[4]])
print(json.dumps({"import_s": t1 - t0,
                  "main_s": time.perf_counter() - t1}))
"""


def pixel_digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def phase_prep(cfg, imgs, card):
    """Data prep on the card machine, with no Pillow in the port: the port's
    readers and prep against expected.json (Pillow's pixels and the JAX
    pipeline's outputs, recorded with the fixtures), then training on what
    it prepared. Returns the K6 launches of the training run."""
    from l3c_torch.cli import classic as classic_cli
    from l3c_torch.cli import prep_pipeline
    from l3c_torch.cli import train as train_cli
    from l3c_torch.data import images as timages
    from l3c_torch.data import offline_corpus, resample
    from l3c_torch.eval import classic
    from l3c_torch.train.trainer import Trainer
    with open(os.path.join(PREP_FIXTURES, "expected.json")) as f:
        exp = json.load(f)
    cpu = host_cpu()
    # ---- 1. every fixture decoded (or refused) as expected
    for n, e in sorted(exp["files"].items()):
        p = os.path.join(PREP_FIXTURES, n)
        head = (timages.image_mode(p), list(timages.image_size(p)))
        if head != (e["mode"], e["size"]):
            raise RuntimeError(f"{n}: mode/size {head}, expected "
                               f"{(e['mode'], e['size'])}")
        if "refused" in e:
            try:
                timages.load_image_uint8(p)
            except ValueError as err:
                if e["refused"] not in str(err):
                    raise RuntimeError(f"{n} refused for another reason: "
                                       f"{err}") from err
            else:
                raise RuntimeError(f"{n} decoded; it must be refused")
        elif pixel_digest(timages.load_image_uint8(p)) != e["sha256"]:
            raise RuntimeError(f"{n}: pixels differ from Pillow's")
    log(f"[prep] {len(exp['files'])} fixtures: modes, sizes and pixel "
        "digests equal Pillow's (expected.json), the truncated JPEG refused "
        "with the reason")
    kernels.reset_launches()
    with tempfile.TemporaryDirectory(prefix="l3c_prep_") as d:
        # ---- 2. prep_pipeline --inp_dir against the JAX pipeline's output
        out = os.path.join(d, "out")
        run_cli(prep_pipeline.main, ["--inp_dir", PREP_FIXTURES, out,
                                     "--min_res", str(exp["min_res"])])
        got = {sub: {n: pixel_digest(read_png(os.path.join(out, sub, n)))
                     for n in sorted(os.listdir(os.path.join(out, sub)))}
               for sub in ("train", "val")}
        if got != exp["prep"]:
            raise RuntimeError(f"prep_pipeline --inp_dir kept {got}, the "
                               f"JAX pipeline {exp['prep']}")
        with open(os.path.join(out, "cache.pkl"), "rb") as f:
            cache = pickle.load(f)
        listed = {os.path.basename(k[0]): sorted(map(os.path.basename, v))
                  for k, v in cache.items()}
        if listed != {sub: sorted(got[sub]) for sub in got}:
            raise RuntimeError(f"the cache lists {listed}")
        log(f"[prep] prep_pipeline --inp_dir --min_res {exp['min_res']}: "
            f"train {sorted(got['train'])}, val {sorted(got['val'])}; every "
            "output's pixels the JAX pipeline's, the cache listing both")
        # ---- 3. --offline where the corpus's packages are absent
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            run_cli(prep_pipeline.main, ["--offline", os.path.join(d, "off")])
        want = [f"offline corpus: missing {rel} (skipped)"
                for rel, _, _ in offline_corpus.MANIFEST]
        made = [n for sub in ("train", "val", "val_full")
                for n in os.listdir(os.path.join(d, "off", sub))]
        if err.getvalue().splitlines() != want or made:
            raise RuntimeError(f"--offline: {err.getvalue()!r}, made "
                               f"{len(made)} tiles")
        log(f"[prep] --offline under {offline_corpus._site_packages()}: "
            f"every one of the {len(want)} manifest sources and the skybox "
            "reported missing, empty splits (as the JAX pipeline with no "
            "sources)")
        # ---- 4. r5b resumed on the prepared data, validating on its val
        ms_cf = os.path.join(l3c_cli.default_config_roots()[0], "ms", "cr.cf")
        dl_cf = os.path.join(l3c_cli.default_config_roots()[0], "dl",
                             "oi_offline.cf")
        root = os.path.join(d, "logs")
        os.makedirs(root)
        r5b_dir = os.path.dirname(os.path.dirname(CKPT))
        os.symlink(r5b_dir, os.path.join(root, os.path.basename(r5b_dir)))
        losses, steps = [], []

        def step(orig):
            def run(self, batch_):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = orig(self, batch_)
                losses.append(float(m["loss_bpsp"]))
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t0)
                return m
            return run

        train_counts = {}
        with patched(Trainer, "train_step", step):
            counted(train_counts, "cli.train on the prepared data",
                    lambda: run_cli(train_cli.main, [
                        ms_cf, dl_cf, root, "-p",
                        f"dl.train_imgs_glob='{os.path.join(out, 'train')}'",
                        "-p", f"dl.val_glob='{os.path.join(out, 'val')}'",
                        "-p", "dl.image_cache_pkl=None", "-p",
                        "lr.schedule='none'", "--restore", LOG_DATE,
                        "--num_itr", str(PREP_STEPS), "--log_train", "1",
                        "--log_val", str(PREP_STEPS)]), PREP_TRAIN)
        if len(losses) != PREP_STEPS or not all(map(math.isfinite, losses)):
            raise RuntimeError(f"training on the prepared data: {losses}")
        from l3c_torch.models.weights import list_ckpts
        new = [n for n in os.listdir(root) if not n.startswith(LOG_DATE)]
        end = 246250 + PREP_STEPS
        itr, ck = list_ckpts(os.path.join(root, new[0]))[-1]
        back = MultiscaleNetwork(cfg)
        if itr != end or load_network_weights(back, ck) != end or not all(
                torch.isfinite(p).all() for p in back.parameters()):
            raise RuntimeError(f"{ck} does not restore")
        log(f"[prep] cli.train, r5b resumed {PREP_STEPS} steps on the "
            f"prepared train/ (batch 16 x 128^2), validating on val/: losses "
            f"{[round(v, 4) for v in losses]}, step ms "
            f"{[round(1e3 * v, 1) for v in steps]}; {os.path.basename(ck)} "
            f"restores strictly (step {end}) | {card}")
        # ---- 5. cli.classic with the PNG column on the bench images
        img_dir = os.path.join(d, "bench")
        os.makedirs(img_dir)
        for i, im in enumerate(imgs):
            write_png(os.path.join(img_dir, f"im{i}.png"), im[0])
        line = run_cli(classic_cli.main, [img_dir]).strip()
        sizes = [classic.png_size(im[0]) for im in imgs]
        same = sizes == exp["classic_png_bytes"]
        if zlib.ZLIB_RUNTIME_VERSION == exp["zlib"] and not same:
            raise RuntimeError(f"optimized-PNG bytes {sizes}, Pillow's "
                               f"{exp['classic_png_bytes']}")
        held = (f"{'equal to' if same else 'unlike'} Pillow's optimize=True "
                f"(expected.json, zlib {exp['zlib']}; this host's zlib "
                f"{zlib.ZLIB_RUNTIME_VERSION}: "
                f"{'held' if zlib.ZLIB_RUNTIME_VERSION == exp['zlib'] else 'reported, not held'})")
        log(f"[prep] cli.classic over the {len(imgs)} bench PNGs: "
            f"{line.split(': ', 1)[1]}; PNG bytes {sizes} {held}")
        # ---- 6. host rates on a photograph-sized JPEG
        (name, e), = exp["rate"].items()
        photo = os.path.join(PREP_RATE, name)
        h, w = e["size"]
        t0 = time.perf_counter()
        for _ in range(3):
            arr = timages.load_image_uint8(photo)
        jpeg_mps = 3 * h * w / (time.perf_counter() - t0) / 1e6
        if pixel_digest(arr) != e["sha256"]:
            raise RuntimeError(f"{name}: pixels differ from Pillow's")
        t0 = time.perf_counter()
        for _ in range(3):
            resample.resize(arr, (round(0.7 * w), round(0.7 * h)))
        lanczos_mps = 3 * h * w / (time.perf_counter() - t0) / 1e6
        dump = os.path.join(d, "dump")
        os.makedirs(dump)
        for c in range(PREP_RATE_COPIES):
            os.symlink(photo, os.path.join(dump, f"{c:03d}_{name}"))
        rates, outs = {}, {}
        for workers in (1, os.cpu_count() or 1):
            dst = os.path.join(d, f"rate{workers}")
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-c", PREP_RATE_SCRIPT, dump, dst,
                 str(PREP_RATE_MIN_RES), str(workers)], cwd=ROOT,
                capture_output=True, text=True, check=True, timeout=300)
            wall = time.perf_counter() - t0
            rates[workers] = (json.loads(run.stdout.splitlines()[-1]), wall)
            outs[workers] = (run.stdout.splitlines()[:2], {
                sub: {n: hashlib.sha256(open(os.path.join(dst, sub, n),
                                             "rb").read()).hexdigest()
                      for n in os.listdir(os.path.join(dst, sub))}
                for sub in ("train", "val")})
        if outs[1] != outs[os.cpu_count() or 1] or sum(
                map(len, outs[1][1].values())) != PREP_RATE_COPIES:
            raise RuntimeError(f"prep_pipeline over {PREP_RATE_COPIES} "
                               f"copies: {outs[1][0]}; the outputs must "
                               "not depend on --workers")
        n_img, mp = PREP_RATE_COPIES, PREP_RATE_COPIES * h * w / 1e6
        log(f"[prep] host rates on {name} ({w} x {h}, "
            f"{os.path.getsize(photo)} bytes): baseline JPEG decode "
            f"{jpeg_mps:.3f} MP/s; Lanczos -> {round(0.7 * w)} x "
            f"{round(0.7 * h)} {lanczos_mps:.3f} input MP/s; prep_pipeline "
            f"--inp_dir over {n_img} copies --min_res {PREP_RATE_MIN_RES} "
            f"(all kept, the same outputs): "
            + "; ".join(
                f"{k} worker(s) {n_img / r['main_s']:.3f} images/s "
                f"({mp / r['main_s']:.3f} MP/s) in main(), "
                f"{n_img / wall:.3f} images/s with the process's start "
                f"(import {r['import_s']:.2f} s, wall {wall:.2f} s)"
                for k, (r, wall) in rates.items())
            + f" | host {cpu}")
    return train_counts


# ----------------------------------------------------------------- synth

SYNTH_FIXTURES = os.path.join(ROOT, "l3c_torch", "data", "fixtures",
                              "synth")
SYNTH_FAMILIES, SYNTH_TILES, SYNTH_TILE = 33, 2, 256
SYNTH_VAL_FAMILIES = ("spectral", "shapes")    # held out, other seeds
SYNTH_STEPS = 5
SYNTH_TRAIN = {"dmll_nll": SYNTH_STEPS * 3 + 2 * 3,
               "dmll_nll_grad": SYNTH_STEPS * 3}
SYNTH_CODEC_Q = 75          # the encoder's and decoder's rates: Pillow's
                            # default quality
# prep_pipeline.main(argv) in a fresh process, as `python -m
# l3c_torch.cli.prep_pipeline` runs it: its import and its work timed
# apart, and the JPEG blocks its round trips saturated
SYNTH_CLI_SCRIPT = """
import json, sys, time
t0 = time.perf_counter()
from l3c_torch.cli import prep_pipeline
from l3c_torch.data import jpeg, synth  # what main() reaches
t1 = time.perf_counter()
rc = prep_pipeline.main(sys.argv[1:])
print(json.dumps({"rc": rc, "import_s": t1 - t0,
                  "main_s": time.perf_counter() - t1,
                  "saturated_blocks": jpeg.COUNTS["saturated_blocks"]}))
"""


def fixture_tile(exp, name, got, same_numpy) -> int:
    """Pixels of `got` differing from fixture `name` by one grey level;
    raises where any pixel differs on a host whose numpy probe is the
    fixtures', or by more than one elsewhere."""
    if pixel_digest(got) == exp["tiles"][name]:
        return 0
    if same_numpy:
        raise RuntimeError(f"{name}: pixels differ from the JAX package's "
                           "on a host whose numpy probe is the fixtures'")
    d = np.abs(got.astype(np.int16) - read_png(os.path.join(
        SYNTH_FIXTURES, name)))
    if d.max() > 1:
        raise RuntimeError(f"{name}: {int((d > 1).sum())} pixels differ from"
                           f" the JAX package's by more than 1 (up to "
                           f"{int(d.max())})")
    return int((d > 0).sum())


def phase_synth(cfg, card):
    """The procedural source families on the card machine's host (numpy, as
    in JAX; the port calls no Pillow or scipy) against the JAX package's
    fixtures, the synth corpus built by prep_pipeline as a user builds
    it, then training on it through K6. Returns the K6 launches of the
    training run."""
    from l3c_torch.cli import train as train_cli
    from l3c_torch.data import jpeg, jpeg_encode, synth
    from l3c_torch.models.weights import list_ckpts
    from l3c_torch.train.trainer import Trainer
    with open(os.path.join(SYNTH_FIXTURES, "expected.json")) as f:
        exp = json.load(f)
    cpu = host_cpu()
    saturated = jpeg.COUNTS["saturated_blocks"]
    probe = synth.numpy_probe()
    same = probe == exp["probe"]
    log(f"[synth] numpy {np.__version__}, probe {probe[:16]}: "
        f"{'the fixtures' if same else 'unlike the fixtures'}' (numpy "
        f"{exp['numpy']}, {exp['probe'][:16]}); tiles held "
        f"{'bit for bit' if same else 'within one grey level'} | host {cpu}")
    # ---- 1. the fixtures: each family's tile, two jpegtex tiles
    render_s, off, tiles = {}, {}, {}
    for name in sorted(exp["tiles"]):
        jt = exp["jpegtex"].get(name)
        fam, seed = (("jpegtex", jt["seed"]) if jt else
                     (name[len("tile_"):-len(".png")], exp["seed"]))
        t0 = time.perf_counter()
        got = synth.render_tile(fam, np.random.RandomState(seed), exp["n"])
        if not jt:
            render_s[fam] = time.perf_counter() - t0
            tiles[fam] = got
        off[name] = fixture_tile(exp, name, got, same)
    log(f"[synth] {len(exp['tiles'])} fixture tiles of {exp['n']}^2 (every "
        f"family at seed {exp['seed']}, jpegtex at seeds "
        f"{[v['seed'] for v in exp['jpegtex'].values()]} with "
        f"{[v['family_roundtrips'] for v in exp['jpegtex'].values()]} JPEG "
        f"round trips): pixels one grey level off, a tile: {off}")
    rt = exp["roundtrip"]
    src = np.ascontiguousarray(read_png(os.path.join(
        SYNTH_FIXTURES, rt["from"]))[:rt["rows"], :rt["cols"]])
    if pixel_digest(src) != rt["sha256"]:
        raise RuntimeError(f"{rt['from']} does not hold the round trip's "
                           "source")
    for q in (8, 90):
        blob = jpeg_encode.encode_jpeg(src, q)
        if hashlib.sha256(blob).hexdigest() != rt[str(q)]["jpeg_sha256"]:
            raise RuntimeError(f"encode_jpeg at q {q}: {len(blob)} bytes, "
                               f"unlike Pillow's {rt[str(q)]['jpeg_bytes']}")
        if pixel_digest(synth._jpeg_roundtrip(src, q)) != rt[str(q)][
                "sha256"]:
            raise RuntimeError(f"the JPEG round trip at q {q}: pixels "
                               "differ from Pillow's")
    mp = len(tiles) * exp["n"] ** 2 / 1e6
    t0 = time.perf_counter()
    blobs = [jpeg_encode.encode_jpeg(t, SYNTH_CODEC_Q)
             for t in tiles.values()]
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for b in blobs:
        jpeg.decode_jpeg(b)
    dec_s = time.perf_counter() - t0
    log(f"[synth] JPEG round trip of a {rt['cols']} x {rt['rows']} cut: "
        f"encode_jpeg's files Pillow's byte for byte at q 8 and 90 "
        f"({rt['8']['jpeg_bytes']} and {rt['90']['jpeg_bytes']} bytes), "
        f"decoded pixels Pillow's; over the {len(tiles)} tiles at q "
        f"{SYNTH_CODEC_Q}: encode {mp / enc_s:.3f} MP/s, decode "
        f"{mp / dec_s:.3f} MP/s | host {cpu}")
    kernels.reset_launches()
    with tempfile.TemporaryDirectory(prefix="l3c_synth_") as d:
        # ---- 2. the corpus, as a user builds it, in a fresh process
        out = os.path.join(d, "corpus")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-c", SYNTH_CLI_SCRIPT, "--offline", out,
             "--synth_families", str(SYNTH_FAMILIES), "--synth_tiles",
             str(SYNTH_TILES), "--tile", str(SYNTH_TILE)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if run.returncode:
            raise RuntimeError(f"prep_pipeline --synth_families: rc "
                               f"{run.returncode}\n{run.stdout}{run.stderr}")
        res = json.loads(run.stdout.splitlines()[-1])
        saturated -= res["saturated_blocks"]
        n_tiles = SYNTH_FAMILIES * SYNTH_TILES
        want_line = (f"[synth] {n_tiles} tiles across {SYNTH_FAMILIES} "
                     f"families -> {os.path.join(out, 'synth')}")
        if want_line not in run.stdout.splitlines():
            raise RuntimeError(f"prep_pipeline printed {run.stdout!r}")
        names = sorted(os.listdir(os.path.join(out, "synth")))
        train = sorted(os.listdir(os.path.join(out, "train")))
        if train != ["x_" + n for n in names] or len(names) != n_tiles:
            raise RuntimeError(f"the train split holds {len(train)} files "
                               f"({train[:4]}...), not the {n_tiles} "
                               "x_synth_* tiles")
        with open(os.path.join(out, "cache.pkl"), "rb") as f:
            cache = pickle.load(f)
        listed = {os.path.basename(k[0]): sorted(map(os.path.basename, v))
                  for k, v in cache.items()}
        if listed.get("train") != train or listed.get("val") != []:
            raise RuntimeError(f"the cache lists {listed}")
        fams = list(synth.FAMILIES)[:SYNTH_FAMILIES]
        differ = []
        for n in names:
            px = read_png(os.path.join(out, "synth", n))
            if read_png(os.path.join(out, "train", "x_" + n)).tobytes() \
                    != px.tobytes():
                raise RuntimeError(f"train/x_{n} is not synth/{n}")
            if pixel_digest(px) == exp["prep"]["sha256"][n]:
                continue
            if same:
                raise RuntimeError(f"{n}: pixels differ from the JAX "
                                   "pipeline's")
            fam, t = n[len("synth_"):-len(".png")].rsplit("_", 1)
            again = synth.render_tile(fam, np.random.RandomState(
                fams.index(fam) * 100003 + int(t) + 1), SYNTH_TILE)
            if not np.array_equal(again, px):
                raise RuntimeError(f"{n}: the CLI's tile is not render_tile's"
                                   " for its seed")
            differ.append(n)
        slow = sorted(render_s.items(), key=lambda kv: -kv[1])[:5]
        log(f"[synth] prep_pipeline --offline --synth_families "
            f"{SYNTH_FAMILIES} --synth_tiles {SYNTH_TILES} --tile "
            f"{SYNTH_TILE} in a fresh process: {n_tiles} x_synth_* train "
            f"tiles and nothing else (no corpus package here), the cache "
            f"listing them, pixels the JAX pipeline's "
            + ("bit for bit" if not differ else
               f"except {len(differ)} tiles, each render_tile's on this host")
            + f"; {n_tiles / res['main_s']:.3f} tiles/s in main() "
            f"({res['main_s']:.2f} s), {n_tiles / cli_s:.3f} with the "
            f"process's start (import {res['import_s']:.2f} s, wall "
            f"{cli_s:.2f} s); render_tile in-process "
            f"{len(render_s) / sum(render_s.values()):.3f} tiles/s, slowest "
            f"{[(k, round(1e3 * v, 1)) for k, v in slow]} ms | host {cpu}")
        # ---- 3. r5b resumed on the synth corpus, validating on two synth
        # tiles held out (seed 1 of generate_families: other tiles)
        val = os.path.join(d, "val")
        synth.generate_families(val, 1, n=SYNTH_TILE, seed=1,
                                families=list(SYNTH_VAL_FAMILIES))
        ms_cf = os.path.join(l3c_cli.default_config_roots()[0], "ms", "cr.cf")
        dl_cf = os.path.join(l3c_cli.default_config_roots()[0], "dl",
                             "oi_offline.cf")
        root = os.path.join(d, "logs")
        os.makedirs(root)
        r5b_dir = os.path.dirname(os.path.dirname(CKPT))
        os.symlink(r5b_dir, os.path.join(root, os.path.basename(r5b_dir)))
        losses, steps = [], []

        def step(orig):
            def run_(self, batch_):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = orig(self, batch_)
                losses.append(float(m["loss_bpsp"]))
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t0)
                return m
            return run_

        train_counts = {}
        with patched(Trainer, "train_step", step):
            counted(train_counts, "cli.train on the synth corpus",
                    lambda: run_cli(train_cli.main, [
                        ms_cf, dl_cf, root, "-p",
                        f"dl.train_imgs_glob='{os.path.join(out, 'train')}'",
                        "-p", f"dl.val_glob='{val}'",
                        "-p", "dl.image_cache_pkl=None", "-p",
                        "lr.schedule='none'", "--restore", LOG_DATE,
                        "--num_itr", str(SYNTH_STEPS), "--log_train", "1",
                        "--log_val", str(SYNTH_STEPS)]), SYNTH_TRAIN)
        if len(losses) != SYNTH_STEPS or not all(map(math.isfinite, losses)):
            raise RuntimeError(f"training on the synth corpus: {losses}")
        new = [n for n in os.listdir(root) if not n.startswith(LOG_DATE)]
        end = 246250 + SYNTH_STEPS
        itr, ck = list_ckpts(os.path.join(root, new[0]))[-1]
        back = MultiscaleNetwork(cfg)
        if itr != end or load_network_weights(back, ck) != end or not all(
                torch.isfinite(p).all() for p in back.parameters()):
            raise RuntimeError(f"{ck} does not restore")
        log(f"[synth] cli.train, r5b resumed {SYNTH_STEPS} steps on the "
            f"{n_tiles} synth tiles (batch 16 x 128^2), validating on "
            f"{len(SYNTH_VAL_FAMILIES)} synth tiles held out "
            f"({', '.join(SYNTH_VAL_FAMILIES)}, generate_families seed 1): "
            f"losses {[round(v, 4) for v in losses]}, step ms "
            f"{[round(1e3 * v, 1) for v in steps]}; {os.path.basename(ck)} "
            f"restores strictly (step {end}) | {card}")
    n_sat = jpeg.COUNTS["saturated_blocks"] - saturated
    log(f"[synth] JPEG blocks outside the inverse DCT's agreed range over "
        f"every round trip of this phase (the CLI's included): {n_sat}")
    return train_counts


# --------------------------------------------------------------- formats

FORMATS = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "formats")
FORMATS_RATE = os.path.join(ROOT, "l3c_torch", "data", "fixtures",
                            "formats_rate")
FORMATS_CODED = ("a_prog_420.jpg", "e_lossy.webp")   # through cli.l3c
# every kernel of the serving path, in cli.test --write_to_files --
# compare_theory over the folder (its grouping of the sizes decides how
# often each runs)
FORMATS_TEST_KERNELS = ("rans_encode", "rans_decode", "pack_int", "dmll_nll")


def phase_formats(card):
    """The formats the loader reads beyond PNG and baseline JPEG
    (progressive and CMYK JPEG, lossy, lossless, alpha and animated WebP,
    grey BMP, 16-bit and ASCII PNM), decoded on this machine's host with
    no Pillow, held to Pillow's digests (expected.json); the codec CLIs
    and prep over them; the host's decode rates. Returns the launches of
    its CLI calls."""
    from l3c_torch.cli import prep_pipeline
    from l3c_torch.data import images as timages
    with open(os.path.join(FORMATS, "expected.json")) as f:
        exp = json.load(f)
    cpu = host_cpu()
    # ---- 1. every fixture's mode, size and pixels
    for d, group in ((FORMATS, exp["files"]), (FORMATS_RATE, exp["rate"])):
        for n, e in sorted(group.items()):
            p = os.path.join(d, n)
            head = (timages.image_mode(p), list(timages.image_size(p)))
            if head != (e["mode"], e["size"]):
                raise RuntimeError(f"{n}: mode/size {head}, expected "
                                   f"{(e['mode'], e['size'])}")
            if d == FORMATS and pixel_digest(timages.load_image_uint8(
                    p)) != e["sha256"]:
                raise RuntimeError(f"{n}: pixels differ from Pillow's")
    log(f"[formats] {len(exp['files'])} fixtures "
        f"({', '.join(sorted(exp['files']))}): modes, sizes and pixel "
        "digests equal Pillow's (expected.json, "
        f"made by Pillow {exp['made_by']['pillow']}, libjpeg-turbo "
        f"{exp['made_by']['libjpeg_turbo']}, libwebp "
        f"{exp['made_by']['libwebp']}); the {len(exp['rate'])} rate "
        "fixtures' modes and sizes")
    total = {}
    with tempfile.TemporaryDirectory(prefix="l3c_formats_") as d:
        # ---- 2. cli.l3c enc / dec of a progressive JPEG and a lossy WebP
        for name in FORMATS_CODED:
            src = os.path.join(FORMATS, name)
            coded = os.path.join(d, name + ".l3c")
            back = os.path.join(d, name + ".png")
            counted(total, f"cli.l3c enc {name}", lambda: run_cli(
                l3c_cli.main, [ZOO, LOG_DATE, "enc", src, coded]),
                ENCODE, CANARY)
            counted(total, f"cli.l3c dec {name}", lambda: run_cli(
                l3c_cli.main, [ZOO, LOG_DATE, "dec", coded, back]),
                DECODE, CANARY)
            if not np.array_equal(read_png(back),
                                  timages.load_image_uint8(src)):
                raise RuntimeError(f"cli.l3c dec of {name} differs from the "
                                   "loader's pixels")
            h, w = timages.image_size(src)
            log(f"[formats] cli.l3c enc+dec of {name} ({w} x {h}) "
                f"bit-exact against the loader's pixels: file bpsp "
                f"{os.path.getsize(coded) * 8 / (3 * h * w):.4f} | {card}")
        # ---- 3. cli.test --write_to_files over the folder
        out_dir = os.path.join(d, "out")
        kernels.reset_launches()
        out = run_cli(test_cli.main, [ZOO, LOG_DATE, FORMATS,
                                      "--write_to_files", out_dir,
                                      "--compare_theory", "--reset_cache"])
        got = {k: kernels.launches.get(k, 0) for k in kernels.KERNELS}
        if any(got[k] < 1 for k in FORMATS_TEST_KERNELS):
            raise RuntimeError(f"cli.test over the formats: launches {got}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        n_files = len([n for n in os.listdir(out_dir) if n.endswith(".l3c")])
        if n_files != len(exp["files"]) or \
                out.count("assumed:") != len(exp["files"]):
            raise RuntimeError(f"cli.test wrote {n_files} files")
        log(f"[formats] cli.test --write_to_files --compare_theory over the "
            f"{n_files} fixtures: every file decoded bit-exactly (the "
            f"tester's gate), bpsp {out.strip().splitlines()[-1].split()[-1]}"
            f"; launches {({k: v for k, v in got.items() if v})} | {card}")
        # ---- 4. prep_pipeline --inp_dir against the JAX pipeline's output
        prep_out = os.path.join(d, "prep")
        run_cli(prep_pipeline.main, ["--inp_dir", FORMATS, prep_out,
                                     "--min_res", str(exp["min_res"])])
        got = {sub: {n: pixel_digest(read_png(os.path.join(prep_out, sub,
                                                           n)))
                     for n in sorted(os.listdir(os.path.join(prep_out,
                                                             sub)))}
               for sub in ("train", "val")}
        if got != exp["prep"]:
            raise RuntimeError(f"prep_pipeline --inp_dir kept {got}, the "
                               f"JAX pipeline {exp['prep']}")
        log(f"[formats] prep_pipeline --inp_dir --min_res {exp['min_res']}: "
            f"train {sorted(got['train'])}, val {sorted(got['val'])}: the "
            "JAX pipeline's outputs, pixel for pixel")
    # ---- 5. the host's decode rates, each decode held to its digest
    rates = []
    for n, e in sorted(exp["rate"].items()):
        p = os.path.join(FORMATS_RATE, n)
        t0 = time.perf_counter()
        arr = timages.load_image_uint8(p)
        dt = time.perf_counter() - t0
        if pixel_digest(arr) != e["sha256"]:
            raise RuntimeError(f"{n}: pixels differ from Pillow's")
        h, w = e["size"]
        rates.append(f"{n} ({w} x {h}, {os.path.getsize(p)} bytes) "
                     f"{h * w / dt / 1e6:.4f} MP/s ({dt:.3f} s)")
    log(f"[formats] host decode rates, one decode each, pixels Pillow's: "
        f"{'; '.join(rates)} | host {cpu}")
    return total


DAMAGED = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "damaged")
DAMAGED_REFUSED = os.path.join(ROOT, "l3c_torch", "data", "fixtures",
                               "damaged_refused")
# through cli.l3c: a JPEG with damaged entropy data, a PNG whose IDAT CRC
# is wrong
DAMAGED_CODED = ("a_baseline_damaged.jpg", "j_png_bad_idat_crc.png")
# run in a child process where the host has Pillow: how many of the
# damaged fixtures its decode gives expected.json's digest for
HOST_PILLOW_SCRIPT = r"""
import hashlib, json, os, sys
import numpy as np
from PIL import Image, features
d = sys.argv[1]
exp = json.load(open(os.path.join(d, "expected.json")))["files"]
equal = 0
for n, e in exp.items():
    with Image.open(os.path.join(d, n)) as im:
        a = np.ascontiguousarray(np.asarray(im.convert("RGB")))
    equal += hashlib.sha256(a.tobytes()).hexdigest() == e["sha256"]
print(equal, Image.__version__, features.version("libjpeg_turbo"))
"""


def phase_damaged(card):
    """Damaged and partly refined files (corrupt entropy data, cut scans,
    a wrong restart marker, block smoothing, the inverse DCT out of range,
    a PNG's IDAT CRC), decoded on this machine's host with no Pillow, held
    to Pillow's digests (expected.json) and the refused ones refused; the
    codec CLIs and prep over them; the host's decode rates of the clean
    and damaged 1024 x 768 JPEGs. Returns the launches of its CLI calls."""
    from l3c_torch.cli import prep_pipeline
    from l3c_torch.data import images as timages
    from l3c_torch.data import jpeg
    with open(os.path.join(DAMAGED, "expected.json")) as f:
        exp = json.load(f)
    cpu = host_cpu()
    # ---- 1. every fixture's mode, size and pixels; the refusals refused
    for n, e in sorted(exp["files"].items()):
        p = os.path.join(DAMAGED, n)
        head = (timages.image_mode(p), list(timages.image_size(p)))
        if head != (e["mode"], e["size"]):
            raise RuntimeError(f"{n}: mode/size {head}, expected "
                               f"{(e['mode'], e['size'])}")
        if pixel_digest(timages.load_image_uint8(p)) != e["sha256"]:
            raise RuntimeError(f"{n}: pixels differ from Pillow's")
    reasons = []
    for n in sorted(exp["refused"]):
        try:
            timages.load_image_uint8(os.path.join(DAMAGED_REFUSED, n))
        except ValueError as e:
            reasons.append(f"{n}: {str(e).split(': ', 1)[1]}")
            continue
        raise RuntimeError(f"{n}: read, where Pillow refuses it "
                           f"({exp['refused'][n]['refused']})")
    made = exp["made_by"]
    log(f"[damaged] {len(exp['files'])} fixtures "
        f"({', '.join(sorted(exp['files']))}): modes, sizes and pixel "
        f"digests equal Pillow's (expected.json, made by Pillow "
        f"{made['pillow']}, libjpeg-turbo {made['libjpeg_turbo']}, zlib "
        f"{made['zlib']}); the {len(reasons)} files Pillow refuses refused "
        f"too: {'; '.join(reasons)}")
    # ---- 2. this host's Pillow, where it imports: information only (in
    # a child process: the port and this script import no Pillow)
    run = subprocess.run([sys.executable, "-c", HOST_PILLOW_SCRIPT, DAMAGED],
                         capture_output=True, text=True, timeout=300)
    if run.returncode:
        log("[damaged] this host has no Pillow that imports: no second "
            "decode to count")
    else:
        equal, version, lj = run.stdout.split()
        log(f"[damaged] this host's Pillow {version} (libjpeg-turbo {lj}) "
            f"decodes {equal} of the {len(exp['files'])} fixtures to "
            "expected.json's pixels (not held: another libjpeg-turbo may "
            "recover differently)")
    total = {}
    with tempfile.TemporaryDirectory(prefix="l3c_damaged_") as d:
        # ---- 3. cli.l3c enc / dec of a damaged JPEG and the bad-CRC PNG
        for name in DAMAGED_CODED:
            src = os.path.join(DAMAGED, name)
            coded = os.path.join(d, name + ".l3c")
            back = os.path.join(d, name + ".png")
            counted(total, f"cli.l3c enc {name}", lambda: run_cli(
                l3c_cli.main, [ZOO, LOG_DATE, "enc", src, coded]),
                ENCODE, CANARY)
            counted(total, f"cli.l3c dec {name}", lambda: run_cli(
                l3c_cli.main, [ZOO, LOG_DATE, "dec", coded, back]),
                DECODE, CANARY)
            if not np.array_equal(read_png(back),
                                  timages.load_image_uint8(src)):
                raise RuntimeError(f"cli.l3c dec of {name} differs from the "
                                   "loader's pixels")
            h, w = timages.image_size(src)
            log(f"[damaged] cli.l3c enc+dec of {name} ({w} x {h}) "
                f"bit-exact against the loader's pixels: file bpsp "
                f"{os.path.getsize(coded) * 8 / (3 * h * w):.4f} | {card}")
        # ---- 4. cli.test --write_to_files over the folder
        out_dir = os.path.join(d, "out")
        kernels.reset_launches()
        out = run_cli(test_cli.main, [ZOO, LOG_DATE, DAMAGED,
                                      "--write_to_files", out_dir,
                                      "--compare_theory", "--reset_cache"])
        got = {k: kernels.launches.get(k, 0) for k in kernels.KERNELS}
        if any(got[k] < 1 for k in FORMATS_TEST_KERNELS):
            raise RuntimeError(f"cli.test over the damaged: launches {got}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        n_files = len([n for n in os.listdir(out_dir) if n.endswith(".l3c")])
        if n_files != len(exp["files"]) or \
                out.count("assumed:") != len(exp["files"]):
            raise RuntimeError(f"cli.test wrote {n_files} files")
        log(f"[damaged] cli.test --write_to_files --compare_theory over the "
            f"{n_files} fixtures: every file decoded bit-exactly (the "
            f"tester's gate), bpsp {out.strip().splitlines()[-1].split()[-1]}"
            f"; launches {({k: v for k, v in got.items() if v})} | {card}")
        # ---- 5. prep_pipeline --inp_dir against the JAX pipeline's output
        prep_out = os.path.join(d, "prep")
        run_cli(prep_pipeline.main, ["--inp_dir", DAMAGED, prep_out,
                                     "--min_res", str(exp["min_res"])])
        got = {sub: {n: pixel_digest(read_png(os.path.join(prep_out, sub,
                                                           n)))
                     for n in sorted(os.listdir(os.path.join(prep_out,
                                                             sub)))}
               for sub in ("train", "val")}
        if got != exp["prep"]:
            raise RuntimeError(f"prep_pipeline --inp_dir kept {got}, the "
                               f"JAX pipeline {exp['prep']}")
        log(f"[damaged] prep_pipeline --inp_dir --min_res {exp['min_res']}: "
            f"train {sorted(got['train'])}, val {sorted(got['val'])}: the "
            "JAX pipeline's outputs, pixel for pixel")
    # ---- 6. the host's decode rates, clean and damaged, in this one call
    rates = []
    for rel, e in sorted(exp["rate"].items()):
        blob = open(os.path.join(ROOT, "l3c_torch", "data", "fixtures", rel),
                    "rb").read()
        hurt = bytearray(blob)
        hurt[e["at"]] ^= e["xor"]
        h, w = e["size"]
        for tag, b, want in (("clean", blob, None),
                             ("damaged", bytes(hurt), e["sha256"])):
            dt = math.inf
            for _ in range(3):       # the fastest of three decodes
                t0 = time.perf_counter()
                arr = jpeg.decode_jpeg(b, rel)
                dt = min(dt, time.perf_counter() - t0)
            if want is not None and pixel_digest(arr) != want:
                raise RuntimeError(f"{rel} damaged: pixels differ from "
                                   "Pillow's")
            rates.append(f"{os.path.basename(rel)} {tag} "
                         f"{h * w / dt / 1e6:.4f} MP/s ({dt:.3f} s)")
    hurt_at = ", ".join(str(e["at"]) for e in exp["rate"].values())
    log(f"[damaged] host decode rates, same call, fastest of 3, the damaged "
        f"copies' pixels Pillow's (byte {hurt_at} XORed): "
        f"{'; '.join(rates)} | host {cpu} | {card}")
    return total


PILLOW_FORMATS = os.path.join(ROOT, "l3c_torch", "data", "fixtures",
                              "pillow_formats")
# run in a child process where the host has Pillow: each PNG the port
# wrote, held to Pillow's default save of its pixels (the inflated image
# data, and the IDAT split), and counted where the whole files are equal;
# it exits with NO_PILLOW where Pillow does not import, and only then
NO_PILLOW = 75
HOST_PNG_SCRIPT = r"""
import io, struct, sys, zlib
import numpy as np
try:
    from PIL import Image, features
except ImportError as e:
    print(e, file=sys.stderr)
    sys.exit(75)                # NO_PILLOW

def chunks(b):
    out, at = [], 8
    while at < len(b):
        n, t = struct.unpack(">I4s", b[at:at + 8])
        out.append((t, b[at + 8:at + 8 + n]))
        at += 12 + n
    return out

payload = same = 0
for p in sys.argv[1:]:
    port = open(p, "rb").read()
    with Image.open(p) as im:
        f = io.BytesIO()
        Image.fromarray(np.asarray(im.convert("RGB"))).save(f, "PNG")
    pil = f.getvalue()
    w = struct.unpack(">I", port[16:20])[0]
    block = max(65536, 4 * w)
    ok = True
    for b in (port, pil):
        idat = [d for t, d in chunks(b) if t == b"IDAT"]
        ok &= all(len(d) == block for d in idat[:-1])
    inflate = lambda b: zlib.decompress(b"".join(
        d for t, d in chunks(b) if t == b"IDAT"))
    ok &= [t for t, _ in chunks(port)] == [t for t, _ in chunks(pil)]
    payload += ok and inflate(port) == inflate(pil)
    same += port == pil
print(payload, same, Image.__version__, features.version("zlib"),
      zlib.ZLIB_RUNTIME_VERSION)
"""


def phase_pillow_formats(card):
    """The formats Pillow opens beyond PNG, JPEG, PNM, BMP and WebP (GIF,
    TIFF, TGA, ICO, CUR, PCX, SGI, QOI, IM, MSP, SUN, PSD, DDS, DIB, and
    a JP2 and a raw JPEG 2000 codestream), decoded on this machine's host
    with no Pillow and held to Pillow's digests (expected.json), Pillow's
    default AVIF save among them; cli.l3c on a GIF and an LZW TIFF, cli.test
    over the folder (the listing keeps the mislabelled files) and on a
    TIFF alone; the listing-cache CLI; the PNGs the port wrote held to
    Pillow's default save; the host's GIF and TIFF decode rates. Returns
    the launches of its CLI calls."""
    from l3c_torch.data import gif, tiff
    from l3c_torch.data import images as timages
    with open(os.path.join(PILLOW_FORMATS, "expected.json")) as f:
        exp = json.load(f)
    cpu = host_cpu()
    # ---- (a) every fixture's format, mode, size and pixels; refusals by
    # name where expected.json has them
    refused = []
    for n, e in sorted(exp["files"].items()):
        p = os.path.join(PILLOW_FORMATS, n)
        head = (timages.image_format(p), timages.image_mode(p),
                list(timages.image_size(p)))
        if head != (e["format"], e["mode"], e["size"]):
            raise RuntimeError(f"{n}: format/mode/size {head}, expected "
                               f"{(e['format'], e['mode'], e['size'])}")
        if "refused" in e:
            try:
                timages.load_image_uint8(p)
            except ValueError as err:
                if f"{e['refused']} is not decoded" not in str(err):
                    raise
                refused.append(n)
                continue
            raise RuntimeError(f"{n}: decoded, expected a refusal naming "
                               f"{e['refused']}")
        if pixel_digest(timages.load_image_uint8(p)) != e["sha256"]:
            raise RuntimeError(f"{n}: pixels differ from Pillow's")
    made = exp["made_by"]
    log(f"[pillow_formats] {len(exp['files']) - len(refused)} fixtures "
        f"({', '.join(sorted(set(exp['files']) - set(refused)))}): formats,"
        f" modes, sizes and pixel digests equal Pillow's (expected.json, "
        f"made by Pillow {made['pillow']}, libtiff {made['libtiff']}, "
        f"libjpeg-turbo {made['libjpeg_turbo']}, zlib {made['zlib']}); "
        f"refused by name with Pillow's mode and size: "
        f"{', '.join(refused) or 'none'}")
    total, written = {}, []
    with tempfile.TemporaryDirectory(prefix="l3c_pillow_formats_") as d:
        # ---- (b) cli.l3c enc / dec of a GIF and an LZW TIFF
        for name in exp["coded"]:
            src = os.path.join(PILLOW_FORMATS, name)
            coded = os.path.join(d, name + ".l3c")
            back = os.path.join(d, name + ".png")
            counted(total, f"cli.l3c enc {name}", lambda: run_cli(
                l3c_cli.main, [ZOO, LOG_DATE, "enc", src, coded]),
                ENCODE, CANARY)
            counted(total, f"cli.l3c dec {name}", lambda: run_cli(
                l3c_cli.main, [ZOO, LOG_DATE, "dec", coded, back]),
                DECODE, CANARY)
            if not np.array_equal(read_png(back),
                                  timages.load_image_uint8(src)):
                raise RuntimeError(f"cli.l3c dec of {name} differs from the "
                                   "loader's pixels")
            written.append(back)
            h, w = timages.image_size(src)
            log(f"[pillow_formats] cli.l3c enc+dec of {name} ({w} x {h}) "
                f"bit-exact against the loader's pixels: file bpsp "
                f"{os.path.getsize(coded) * 8 / (3 * h * w):.4f} | {card}")
        # ---- (c) cli.test over the folder, then on one TIFF alone
        tif = os.path.join(PILLOW_FORMATS, exp["coded"][1])
        for spec, want in ((PILLOW_FORMATS, exp["tested"]),
                           (tif, [os.path.basename(tif)])):
            out_dir = os.path.join(d, "out_" + os.path.basename(spec))
            kernels.reset_launches()
            out = run_cli(test_cli.main, [ZOO, LOG_DATE, spec,
                                          "--write_to_files", out_dir,
                                          "--compare_theory",
                                          "--reset_cache"])
            got = {k: kernels.launches.get(k, 0) for k in kernels.KERNELS}
            if any(got[k] < 1 for k in FORMATS_TEST_KERNELS):
                raise RuntimeError(f"cli.test over {spec}: launches {got}")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
            files = sorted(n[:-4] for n in os.listdir(out_dir)
                           if n.endswith(".l3c"))
            if files != sorted(os.path.splitext(n)[0] for n in want) or \
                    out.count("assumed:") != len(want):
                raise RuntimeError(f"cli.test over {spec} wrote {files}, "
                                   f"expected {want}")
            log(f"[pillow_formats] cli.test --write_to_files "
                f"--compare_theory on {os.path.basename(spec)}: {want} "
                f"decoded bit-exactly (the tester's gate), bpsp "
                f"{out.strip().splitlines()[-1].split()[-1]}; launches "
                f"{({k: v for k, v in got.items() if v})} | {card}")
        # ---- (d) the listing-cache CLI with --min_size
        pkl = os.path.join(d, "cache.pkl")
        size = str(exp["listing_min_size"])
        run_cli(timages._cache_cli, ["update", pkl, PILLOW_FORMATS,
                                     "--min_size", size])
        shown = run_cli(timages._cache_cli, ["show", pkl])
        with open(pkl, "rb") as f:
            listed = [os.path.basename(p) for p in pickle.load(f)[
                (PILLOW_FORMATS, int(size))]]
        if listed != exp["listing"]:
            raise RuntimeError(f"the cache CLI listed {listed}, the JAX "
                               f"package {exp['listing']}")
        log(f"[pillow_formats] the listing-cache CLI (what python -m "
            f"l3c_torch.data.images runs) update --min_size {size}: "
            f"{listed}, the JAX listing; show: {shown.strip()!r}")
        # ---- (e) the PNGs the tester wrote against Pillow's default save,
        # in a child process (the port and this script import no Pillow)
        run = subprocess.run([sys.executable, "-c", HOST_PNG_SCRIPT,
                              *written], capture_output=True, text=True,
                             timeout=300)
        fields = run.stdout.split()
        if run.returncode == NO_PILLOW:
            log("[pillow_formats] this host has no Pillow that imports: the "
                f"written PNGs not held ({run.stderr.strip()[-200:]})")
        elif run.returncode or len(fields) != 5 or \
                not all(f.isdigit() for f in fields[:2]):
            raise RuntimeError(f"holding the written PNGs to Pillow's save "
                               f"failed (exit {run.returncode}): stdout "
                               f"{run.stdout.strip()[-500:]!r}, stderr "
                               f"{run.stderr.strip()[-2000:]}")
        else:
            payload, same, version, pz, pyz = fields
            if int(payload) != len(written):
                raise RuntimeError(f"{len(written) - int(payload)} written "
                                   "PNGs differ from Pillow's image data")
            log(f"[pillow_formats] the {len(written)} PNGs cli.l3c dec wrote:"
                f" image data and IDAT split equal Pillow {version}'s default"
                f" save; {same} of {len(written)} byte-equal (Pillow's zlib "
                f"{pz}, Python's zlib {pyz})")
    # ---- (f) the host's decode rates of the GIF and TIFF fixtures
    rates = []
    for name in exp["coded"]:
        e = exp["files"][name]
        blob = open(os.path.join(PILLOW_FORMATS, name), "rb").read()
        decode = gif.decode_gif if e["format"] == "GIF" else tiff.decode_tiff
        dt = math.inf
        for _ in range(3):           # the fastest of three decodes
            t0 = time.perf_counter()
            arr = decode(blob, name)
            dt = min(dt, time.perf_counter() - t0)
        if pixel_digest(arr) != e["sha256"]:
            raise RuntimeError(f"{name}: pixels differ from Pillow's")
        h, w = e["size"]
        rates.append(f"{name} ({w} x {h}, {len(blob)} bytes) "
                     f"{h * w / dt / 1e6:.4f} MP/s ({dt * 1e3:.1f} ms)")
    log(f"[pillow_formats] host decode rates, fastest of 3, pixels "
        f"Pillow's: {'; '.join(rates)} | host {cpu}")
    return total


JPEG2000 = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "jpeg2000")
JPEG2000_CODING = os.path.join(ROOT, "l3c_torch", "data", "fixtures",
                               "jpeg2000_coding")
# run in a child process where the host has Pillow: its OpenJPEG version
# and how many of the given files its decode gives the digest expected
# (reported, not held); it exits with NO_PILLOW where Pillow does not
# import, and only then
HOST_J2K_SCRIPT = r"""
import hashlib, json, sys
import numpy as np
try:
    from PIL import Image, features
except ImportError as e:
    print(e, file=sys.stderr)
    sys.exit(75)                # NO_PILLOW
want = json.loads(sys.argv[1])
same = 0
for p, digest in want.items():
    try:
        with Image.open(p) as im:
            px = np.ascontiguousarray(np.asarray(im.convert("RGB")))
        same += hashlib.sha256(px.tobytes()).hexdigest() == digest
    except Exception:
        pass
print(same, len(want), Image.__version__, features.version("jpg_2000"))
"""


def fixtures_hold(folder, exp) -> Tuple[List[str], List[str]]:
    """Every file of `folder`'s expected.json: format, mode and size from
    the header, and Pillow's pixel digest, or the port's refusal, a
    ValueError that says what expected.json says: by name ("refused") or
    as the port gives Pillow's reason ("port"). Returns (decoded,
    refused)."""
    from l3c_torch.data import images as timages
    decoded, refused = [], []
    for n, e in sorted(exp.items()):
        p = os.path.join(folder, n)
        if "format" in e:
            head = (timages.image_format(p), timages.image_mode(p),
                    list(timages.image_size(p)))
            if head != (e["format"], e["mode"], e["size"]):
                raise RuntimeError(f"{n}: format/mode/size {head}, expected "
                                   f"{(e['format'], e['mode'], e['size'])}")
        if "sha256" in e:
            if pixel_digest(timages.load_image_uint8(p)) != e["sha256"]:
                raise RuntimeError(f"{n}: pixels differ from Pillow's")
            decoded.append(n)
            continue
        try:
            timages.load_image_uint8(p)
        except ValueError as err:
            want = (f"{e['refused']} is not decoded" if "refused" in e
                    else e.get("port"))
            if want is None or want not in str(err):
                raise RuntimeError(f"{n}: refused with {err}; expected "
                                   f"{want!r}") from None
            refused.append(n)
            continue
        raise RuntimeError(f"{n}: decoded, expected a refusal")
    return decoded, refused


def code_and_test(folder, exp, tag, card, test=True):
    """cli.l3c enc / dec of each of expected.json's "coded" files,
    bit-exact against the loader's pixels with exact launch counts, then,
    where `test`, cli.test --write_to_files --compare_theory over the
    folder, whose listing must be its "tested" files. Returns the
    launches of the calls."""
    from l3c_torch.data import images as timages
    total = {}
    with tempfile.TemporaryDirectory(prefix=f"l3c_{tag}_") as d:
        for name in exp["coded"]:
            src = os.path.join(folder, name)
            coded = os.path.join(d, name + ".l3c")
            back = os.path.join(d, name + ".png")
            counted(total, f"cli.l3c enc {name}", lambda: run_cli(
                l3c_cli.main, [ZOO, LOG_DATE, "enc", src, coded]),
                ENCODE, CANARY)
            counted(total, f"cli.l3c dec {name}", lambda: run_cli(
                l3c_cli.main, [ZOO, LOG_DATE, "dec", coded, back]),
                DECODE, CANARY)
            # fixtures_hold held the loader's pixels to this digest: a
            # second decode of a slow file is saved
            want = exp["files"].get(name, {}).get("sha256")
            if not (pixel_digest(read_png(back)) == want if want else
                    np.array_equal(read_png(back),
                                   timages.load_image_uint8(src))):
                raise RuntimeError(f"cli.l3c dec of {name} differs from the "
                                   "loader's pixels")
            h, w = timages.image_size(src)
            log(f"[{tag}] cli.l3c enc+dec of {name} ({w} x {h}, "
                f"{timages.image_format(src)} {timages.image_mode(src)}) "
                f"bit-exact against the loader's pixels: file bpsp "
                f"{os.path.getsize(coded) * 8 / (3 * h * w):.4f} | {card}")
        if not test:
            return total
        out_dir = os.path.join(d, "out")
        kernels.reset_launches()
        out = run_cli(test_cli.main, [ZOO, LOG_DATE, folder,
                                      "--write_to_files", out_dir,
                                      "--compare_theory", "--reset_cache"])
        got = {k: kernels.launches.get(k, 0) for k in kernels.KERNELS}
        if any(got[k] < 1 for k in FORMATS_TEST_KERNELS):
            raise RuntimeError(f"cli.test over {folder}: launches {got}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        files = sorted(n[:-4] for n in os.listdir(out_dir)
                       if n.endswith(".l3c"))
        if files != sorted(os.path.splitext(n)[0] for n in exp["tested"]) \
                or out.count("assumed:") != len(exp["tested"]):
            raise RuntimeError(f"cli.test over {folder} wrote {files}, "
                               f"expected {exp['tested']}")
        log(f"[{tag}] cli.test --write_to_files --compare_theory on the "
            f"folder: {exp['tested']} decoded bit-exactly (the tester's "
            f"gate), bpsp {out.strip().splitlines()[-1].split()[-1]}; "
            f"launches {({k: v for k, v in got.items() if v})} | {card}")
    return total


def phase_jpeg2000(card):
    """JPEG 2000 (JP2 and raw codestreams) and ICNS, decoded on this
    machine's host with no Pillow: every fixture of
    l3c_torch/data/fixtures/jpeg2000 and jpeg2000_coding held to Pillow's
    format, mode, size and pixel digest (expected.json), the truncated
    file and the ones Pillow refuses refused; cli.l3c enc
    / dec of a lossy 9/7 JP2 and a lossless raw codestream bit-exact with
    exact launch counts; cli.test --write_to_files --compare_theory over
    the folder (its listing keeps a JP2 named .png and a codestream named
    .jpg); this host's Pillow and OpenJPEG, and how many fixtures its
    Pillow decodes to the digests (reported); the host's decode rates of
    the two coded files. Returns the launches of its CLI calls."""
    from l3c_torch.data import jpeg2000
    with open(os.path.join(JPEG2000, "expected.json")) as f:
        exp = json.load(f)
    with open(os.path.join(JPEG2000_CODING, "expected.json")) as f:
        coding = json.load(f)
    cpu = host_cpu()
    # ---- (a) every fixture's format, mode, size and pixels; refusals
    t0 = time.perf_counter()
    decoded, refused = fixtures_hold(JPEG2000, exp["files"])
    c_dec, c_ref = fixtures_hold(JPEG2000_CODING, coding["files"])
    made = exp["made_by"]
    log(f"[jpeg2000] {len(decoded)} fixtures ({', '.join(decoded)}) and "
        f"{len(c_dec)} of jpeg2000_coding: formats, modes, sizes and pixel "
        f"digests equal Pillow's (expected.json, made by Pillow "
        f"{made['pillow']}, OpenJPEG {made['openjpeg']}, zlib "
        f"{made['zlib']}); refused as Pillow or by name: "
        f"{', '.join(refused)} and {len(c_ref)} of jpeg2000_coding "
        f"({', '.join(c_ref)}); {time.perf_counter() - t0:.1f} s")
    want = {os.path.join(JPEG2000, n): e["sha256"]
            for n, e in exp["files"].items() if "sha256" in e}
    want.update({os.path.join(JPEG2000_CODING, n): e["sha256"]
                 for n, e in coding["files"].items() if "sha256" in e})
    run = subprocess.run([sys.executable, "-c", HOST_J2K_SCRIPT,
                          json.dumps(want)], capture_output=True, text=True,
                         timeout=300)
    if run.returncode == NO_PILLOW:
        log("[jpeg2000] this host has no Pillow that imports: its OpenJPEG "
            f"not known ({run.stderr.strip()[-200:]})")
    elif run.returncode or len(run.stdout.split()) != 4:
        raise RuntimeError(f"the host's Pillow check failed (exit "
                           f"{run.returncode}): {run.stdout.strip()[-300:]!r}"
                           f" {run.stderr.strip()[-1000:]}")
    else:
        same, n, version, opj = run.stdout.split()
        log(f"[jpeg2000] this host's Pillow {version} (OpenJPEG {opj}) "
            f"decodes {same} of the {n} decoded fixtures to the digests "
            "(reported, not held)")
    # ---- (b) cli.l3c enc / dec of the lossy JP2 and the lossless raw
    # codestream; (c) cli.test over the folder
    total = code_and_test(JPEG2000, exp, "jpeg2000", card)
    # ---- (d) the host's decode rates of the two coded files
    rates = []
    for name in exp["coded"]:
        e = exp["files"][name]
        blob = open(os.path.join(JPEG2000, name), "rb").read()
        dt = math.inf
        for _ in range(3):           # the fastest of three decodes
            t0 = time.perf_counter()
            arr = jpeg2000.decode_jpeg2000(blob, name)
            dt = min(dt, time.perf_counter() - t0)
        if pixel_digest(arr) != e["sha256"]:
            raise RuntimeError(f"{name}: pixels differ from Pillow's")
        h, w = e["size"]
        rates.append(f"{name} ({w} x {h}, {len(blob)} bytes, "
                     f"{len(blob) * 8 / (h * w):.3f} bits a pixel) "
                     f"{h * w / dt / 1e6:.4f} MP/s ({dt * 1e3:.1f} ms)")
    log(f"[jpeg2000] host decode rates, fastest of 3, pixels Pillow's: "
        f"{'; '.join(rates)} | host {cpu}")
    # ---- (e) the launches of the phase's CLI calls
    log(f"[jpeg2000] launches of the cli.l3c and cli.test calls: "
        f"{({k: v for k, v in total.items() if v})} | {card}")
    return total


REGISTRY = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "registry")
# run in a child process where the host has Pillow: for each of the given
# files whether its decode gives the digest expected, other pixels, or a
# refusal, its libtiff and OpenJPEG, and where a second file is given
# whether its libtiff reads WebP (the fixture whose strip is a lossless
# WebP file; reported); it exits with NO_PILLOW where Pillow does not
# import, and only then
HOST_FILES_SCRIPT = r"""
import hashlib, json, sys
import numpy as np
try:
    from PIL import Image, features
except ImportError as e:
    print(e, file=sys.stderr)
    sys.exit(75)                # NO_PILLOW
want = json.loads(sys.argv[1])
files = {}
for p, digest in want.items():
    try:
        with Image.open(p) as im:
            px = np.ascontiguousarray(np.asarray(im.convert("RGB")))
        ok = hashlib.sha256(px.tobytes()).hexdigest() == digest
        got = "same" if ok else "differs"
    except Exception as e:
        got = "refuses: " + (type(e).__name__ + ": " + str(e))[:80]
    files[p.rsplit("/", 1)[-1]] = got
webp = None
if len(sys.argv) > 2:
    try:
        with Image.open(sys.argv[2]) as im:
            px = np.asarray(im.convert("RGB"))
        webp = "reads it: pixel (0, 0) " + str(px[0, 0].tolist())
    except Exception as e:
        webp = "refuses it: " + str(e)[:80]
avif = {"libavif": features.version("avif")}
try:                            # the AV1 codecs and libyuv Pillow bundles
    import ctypes, glob, os
    from PIL import _avif
    avif["codecs"] = _avif.codec_versions()
    lib = glob.glob(os.path.join(os.path.dirname(Image.__file__), "..",
                                 "pillow.libs", "libavif*"))
    avif["libyuv"] = ctypes.CDLL(lib[0]).avifLibYUVVersion() if lib else None
except Exception as e:
    avif["error"] = str(e)[:80]
print(json.dumps({"files": files, "pillow": Image.__version__,
                  "libtiff": features.version("libtiff"),
                  "openjpeg": features.version("jpg_2000"), "webp": webp,
                  "avif": avif}))
"""


def phase_registry_formats(card):
    """The rest of Pillow's registry (XBM, XPM, FITS, BLP, SPIDER, GBR, FLI,
    FTEX, PIXAR, MCIDAS, IMT, IPTC, XVThumb) and the TIFF and IM variants
    (CCITT RLE / RLEW / Group 3 / Group 4, LZMA, ZSTD, old-style LZW and
    JPEG, ThunderScan, the float predictor, YCbCr without JPEG, CIELAB,
    12-bit grey; IM's YCbCr, packed, planar and bit types), decoded on
    this machine's host with no Pillow: every fixture of
    l3c_torch/data/fixtures/registry held to Pillow's format, mode, size
    and pixel digest (expected.json), Pillow's refusals refused; cli.l3c
    enc / dec of a Group 4 page and a FITS file
    bit-exact with exact launch counts; cli.test --write_to_files
    --compare_theory over the folder (its listing keeps an XPM named .png
    and a FITS named .jpg); this host's Pillow, where it has the codec,
    decoding every fixture to its digest (held), and its libtiff; the
    host's decode rates
    of a 1728 x 2200 Group 4 fax page and a ZSTD RGB TIFF. Returns the
    launches of its CLI calls."""
    from l3c_torch.data import tiff
    with open(os.path.join(REGISTRY, "expected.json")) as f:
        exp = json.load(f)
    cpu = host_cpu()
    # ---- (a) every fixture's format, mode, size and pixels; refusals
    t0 = time.perf_counter()
    decoded, refused = fixtures_hold(REGISTRY, exp["files"])
    made = exp["made_by"]
    log(f"[registry_formats] {len(decoded)} fixtures decoded: formats, "
        f"modes, sizes and pixel digests equal Pillow's (expected.json, made"
        f" by Pillow {made['pillow']}, libtiff {made['libtiff']}); refused "
        f"as Pillow or by name: {', '.join(refused)}; "
        f"{time.perf_counter() - t0:.1f} s")
    want = {os.path.join(REGISTRY, n): e["sha256"]
            for n, e in exp["files"].items() if "sha256" in e}
    run = subprocess.run([sys.executable, "-c", HOST_FILES_SCRIPT,
                          json.dumps(want), os.path.join(REGISTRY,
                                                         "e_webp.tif")],
                         capture_output=True, text=True, timeout=300)
    if run.returncode == NO_PILLOW:
        log("[registry_formats] this host has no Pillow that imports: its "
            f"TIFF codecs not known ({run.stderr.strip()[-200:]})")
    elif run.returncode:
        raise RuntimeError(f"the host's Pillow check failed (exit "
                           f"{run.returncode}): {run.stdout.strip()[-300:]!r}"
                           f" {run.stderr.strip()[-1000:]}")
    else:
        host = json.loads(run.stdout.strip().splitlines()[-1])
        got = host["files"]
        differ = sorted(n for n, v in got.items() if v == "differs")
        if differ:
            raise RuntimeError(f"this host's Pillow {host['pillow']} decodes "
                               f"{', '.join(differ)} to other pixels than "
                               "expected.json's")
        same = sorted(n for n, v in got.items() if v == "same")
        lacks = {n: v for n, v in got.items() if v.startswith("refuses")}
        tifs = [n for n in same if n.endswith(".tif")]
        log(f"[registry_formats] this host's Pillow {host['pillow']} "
            f"(libtiff {host['libtiff']}) decodes {len(same)} of the "
            f"{len(got)} decoded fixtures, each to its digest (held); it "
            f"lacks the codec of {lacks or 'none'}; the TIFF codecs it "
            f"reads: {', '.join(tifs) or 'none'}; WebP-compressed TIFF: it "
            f"{host['webp']}")
    # ---- (b) cli.l3c enc / dec of the Group 4 page and the FITS file;
    # (c) cli.test over the folder
    total = code_and_test(REGISTRY, exp, "registry_formats", card)
    # ---- (d) the host's decode rates of the fax page and the ZSTD TIFF
    rates = []
    for name in exp["rates"]:
        e = exp["files"][name]
        blob = open(os.path.join(REGISTRY, name), "rb").read()
        dt = math.inf
        for _ in range(3):           # the fastest of three decodes
            t0 = time.perf_counter()
            arr = tiff.decode_tiff(blob, name)
            dt = min(dt, time.perf_counter() - t0)
        if pixel_digest(arr) != e["sha256"]:
            raise RuntimeError(f"{name}: pixels differ from Pillow's")
        h, w = e["size"]
        rates.append(f"{name} ({w} x {h}, {len(blob)} bytes) "
                     f"{h * w / dt / 1e6:.4f} MP/s ({dt * 1e3:.1f} ms)")
    log(f"[registry_formats] host decode rates, fastest of 3, pixels "
        f"Pillow's: {'; '.join(rates)} | host {cpu}")
    # ---- (e) the launches of the phase's CLI calls
    log(f"[registry_formats] launches of the cli.l3c and cli.test calls: "
        f"{({k: v for k, v in total.items() if v})} | {card}")
    return total


HTJ2K = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "htj2k")


def phase_htj2k(card):
    """HTJ2K on this machine's host with no Pillow: every fixture of
    l3c_torch/data/fixtures/htj2k held to Pillow's format, mode, size and
    pixel digest (expected.json), OpenJPEG's refusals refused with its
    reason; this host's Pillow, where it imports, decoding every decoded
    fixture to its digest (held) and the refused ones (reported);
    cli.l3c enc / dec of the 512 x 512 lossless codestream and the 256 x
    256 9/7 JP2 bit-exact with exact launch counts; cli.test
    --write_to_files --compare_theory over the folder; the host's decode
    rates of the two, fastest of 3. Returns the launches of its CLI
    calls."""
    from l3c_torch.data import jpeg2000
    with open(os.path.join(HTJ2K, "expected.json")) as f:
        exp = json.load(f)
    cpu = host_cpu()
    # ---- (a) every fixture's format, mode, size and pixels; refusals
    t0 = time.perf_counter()
    decoded, refused = fixtures_hold(HTJ2K, exp["files"])
    made = exp["made_by"]
    log(f"[htj2k] {len(decoded)} fixtures decoded: formats, modes, sizes "
        f"and pixel digests equal Pillow's (expected.json, made by Pillow "
        f"{made['pillow']}, OpenJPEG {made['openjpeg']}, zlib "
        f"{made['zlib']}); {len(refused)} refused with OpenJPEG's reason "
        f"as Pillow refuses them ({', '.join(refused)}); "
        f"{time.perf_counter() - t0:.1f} s")
    paths = {os.path.join(HTJ2K, n): e.get("sha256", "")
             for n, e in exp["files"].items()}
    run = subprocess.run([sys.executable, "-c", HOST_FILES_SCRIPT,
                          json.dumps(paths)], capture_output=True, text=True,
                         timeout=300)
    if run.returncode == NO_PILLOW:
        log("[htj2k] this host has no Pillow that imports: its OpenJPEG not"
            f" known ({run.stderr.strip()[-200:]})")
    elif run.returncode:
        raise RuntimeError(f"the host's Pillow check failed (exit "
                           f"{run.returncode}): {run.stdout.strip()[-300:]!r}"
                           f" {run.stderr.strip()[-1000:]}")
    else:
        host = json.loads(run.stdout.strip().splitlines()[-1])
        got = host["files"]
        bad = sorted(n for n in decoded if got.get(n) != "same")
        if bad:
            raise RuntimeError(f"this host's Pillow {host['pillow']} "
                               f"(OpenJPEG {host['openjpeg']}) decodes "
                               f"{', '.join(bad)} otherwise than "
                               f"expected.json: {[got.get(n) for n in bad]}")
        agree = sum(got.get(n, "").startswith("refuses") for n in refused)
        log(f"[htj2k] this host's Pillow {host['pillow']} (OpenJPEG "
            f"{host['openjpeg']}) decodes all {len(decoded)} decoded "
            f"fixtures to their digests (held) and refuses {agree} of the "
            f"{len(refused)} refused ones (reported)")
    # ---- (b) cli.l3c enc / dec of the two coded files; (c) cli.test
    total = code_and_test(HTJ2K, exp, "htj2k", card)
    # ---- (d) the host's decode rates of the two coded files
    rates = []
    for name in exp["coded"]:
        e = exp["files"][name]
        blob = open(os.path.join(HTJ2K, name), "rb").read()
        dt = math.inf
        for _ in range(3):           # the fastest of three decodes
            t0 = time.perf_counter()
            arr = jpeg2000.decode_jpeg2000(blob, name)
            dt = min(dt, time.perf_counter() - t0)
        if pixel_digest(arr) != e["sha256"]:
            raise RuntimeError(f"{name}: pixels differ from Pillow's")
        h, w = e["size"]
        rates.append(f"{name} ({w} x {h}, {len(blob)} bytes, "
                     f"{len(blob) * 8 / (h * w):.3f} bits a pixel) "
                     f"{h * w / dt / 1e6:.4f} MP/s ({dt * 1e3:.1f} ms)")
    log(f"[htj2k] host decode rates, fastest of 3, pixels Pillow's: "
        f"{'; '.join(rates)} | host {cpu}")
    # ---- (e) the launches of the phase's CLI calls
    log(f"[htj2k] launches of the cli.l3c and cli.test calls: "
        f"{({k: v for k, v in total.items() if v})} | {card}")
    return total


AVIF = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "avif")
AVIF_DEEP = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "avif_deep")
AVIF_SEQ = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "avif_seq")
AVIF_TOOLS = os.path.join(ROOT, "l3c_torch", "data", "fixtures",
                          "avif_tools")
AVIF_HIDDEN = os.path.join(ROOT, "l3c_torch", "data", "fixtures",
                           "avif_hidden")
AVIF_INTER = os.path.join(ROOT, "l3c_torch", "data", "fixtures",
                          "avif_inter")
# the x86 flags that choose dav1d's transform code at run time
DAV1D_FLAGS = ("avx2", "avx512f", "avx512bw", "avx512vl", "avx512vbmi",
               "avx512_vbmi2", "avx512_vnni", "avx512_bitalg", "avx512ifma",
               "gfni", "vpclmulqdq")


def host_cpu_flags():
    """Which of DAV1D_FLAGS this host's /proc/cpuinfo lists (None where
    it lists no flags)."""
    with open("/proc/cpuinfo") as f:
        line = next((x for x in f if x.startswith("flags")), None)
    if line is None:
        return None
    have = set(line.split(":", 1)[1].split())
    return [x for x in DAV1D_FLAGS if x in have]


def phase_avif(card):
    """AVIF stills, their AV1 frames' in-loop filters (deblocking, CDEF,
    loop restoration), film grain, quantizer matrices, intra block copy
    and premultiplied alpha included, grids, frames and alpha scaled to
    ispe and the matrices libavif converts itself, decoded on this
    machine's host with no Pillow (data/avif.py, av1_*.py, avif_yuv.py,
    avif_scale.py): every fixture of
    l3c_torch/data/fixtures/avif held to Pillow's format, mode, size and
    pixel digest (expected.json), the files with tools the port does not
    decode yet refused by name; this host's Pillow, where it imports,
    decoding every decoded fixture to its digest (a differing one fails),
    its libavif, AV1 codecs and libyuv logged; cli.l3c enc / dec of the
    "coded" files (512 x 512 filters-off lossy 4:2:0, lossless 4:4:4, a
    512 x 512 Pillow default save, a 512 x 512 default save with aom's
    denoiser's film grain, a 1024 x 1024 grid of four 512 x 512 cells at
    Pillow's default quality and speed) bit-exact with exact launch
    counts; cli.test --write_to_files --compare_theory over the folder
    (its listing keeps an AVIF named .png); the host's decode rates of
    the coded files, fastest of 3, and the default, grain and grid saves'
    time by stage. The 10- and 12-bit fixtures of
    l3c_torch/data/fixtures/avif_deep (the 8-bit files' streams with their
    depth rewritten) likewise: held to Pillow's digests, or refused as
    Pillow refuses them, the host's Pillow's digests held; cli.l3c enc /
    dec of the 512 x 512 default save at 10 bits, its decode rate beside
    the 8-bit save's and its time by stage. The image sequences of
    l3c_torch/data/fixtures/avif_seq (Pillow's save_all files, read as
    frame 0 of their colour track, with and without a meta box, flipped
    and refused ones, the track or the item as the brands choose, 10 and
    12 bits) likewise: held to Pillow's digests, or refused as Pillow
    refuses them, the host's Pillow's digests held; cli.l3c enc / dec of
    a 512 x 512 two-frame default save, its decode rate beside the
    still's. The AV1 tools of l3c_torch/data/fixtures/avif_tools (superres
    at denominators 9 to 16 in every layout, with alpha, grain, tiles,
    restoration, screen content, at 10 and 12 bits, in a sequence;
    per-block loop filter deltas; segment reference features; Pillow's
    files rewritten) likewise: held to Pillow's digests, or refused as
    Pillow refuses them, the host Pillow's digests held; cli.l3c enc / dec
    of a 256-wide default save coded at superres denominator 16 (512 x
    512 upscaled), its decode rate beside the still's and its time by
    stage (the upscale's included). The hidden frames of
    l3c_torch/data/fixtures/avif_hidden (shown through
    show_existing_frame, an inter frame after a hidden key frame among
    them) likewise, and the f11_ files (transforms past valid
    coefficients): the host Pillow's digests of the f11_ files reported
    beside this host's AVX-512 flags and those the fixtures were made
    under (dav1d picks its transform code by the CPU); cli.l3c enc / dec
    of a 512 x 512 default save hidden in slot 3 behind a second 512 x
    512 picture, its decode rate (both frames walked) beside the still's
    and its time by stage. The inter frames of
    l3c_torch/data/fixtures/avif_inter (Pillow's sequences, their
    rewrites at 10 and 12 bits, with superres and global motion, hidden
    frames, layered items, the f13_ transforms) likewise, the host
    Pillow's digests of the f13_ files reported as the f11_ ones, the
    rest held, the layered items (libavif's choice of layer) among them;
    every
    frame of every avif_inter file held to Pillow's seek(k) digests;
    cli.l3c enc / dec of a 512 x 512 layered still that shows an inter
    frame, its decode rate beside the still's and its time by stage, the
    inter prediction among them. Returns the launches of its CLI
    calls."""
    from l3c_torch.data import avif
    with open(os.path.join(AVIF, "expected.json")) as f:
        exp = json.load(f)
    with open(os.path.join(AVIF_DEEP, "expected.json")) as f:
        deep = json.load(f)
    with open(os.path.join(AVIF_SEQ, "expected.json")) as f:
        seqs = json.load(f)
    with open(os.path.join(AVIF_TOOLS, "expected.json")) as f:
        tools = json.load(f)
    with open(os.path.join(AVIF_HIDDEN, "expected.json")) as f:
        hid = json.load(f)
    with open(os.path.join(AVIF_INTER, "expected.json")) as f:
        itr = json.load(f)
    cpu = host_cpu()
    # ---- (a) every fixture's format, mode, size and pixels; refusals
    t0 = time.perf_counter()
    decoded, refused = fixtures_hold(AVIF, exp["files"])
    made = exp["made_by"]
    log(f"[avif] {len(decoded)} fixtures decoded: formats, modes, sizes and "
        f"pixel digests equal Pillow's (expected.json, made by Pillow "
        f"{made['pillow']}, libavif {made['libavif']}, dav1d "
        f"{made['dav1d']}, aom {made['aom']}, libyuv {made['libyuv']}); "
        f"{len(refused)} refused by name ({', '.join(refused)}); "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    d_dec, d_ref = fixtures_hold(AVIF_DEEP, deep["files"])
    log(f"[avif] {len(d_dec)} 10- and 12-bit fixtures decoded to Pillow's "
        f"digests (avif_deep/expected.json); {len(d_ref)} refused as Pillow "
        f"{deep['made_by']['pillow']} refuses them ({', '.join(d_ref)}); "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s_dec, s_ref = fixtures_hold(AVIF_SEQ, seqs["files"])
    log(f"[avif] {len(s_dec)} image sequences decoded to Pillow's digests "
        f"of their first frame (avif_seq/expected.json); {len(s_ref)} "
        f"refused as Pillow {seqs['made_by']['pillow']} refuses them "
        f"({', '.join(s_ref)}); {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    t_dec, t_ref = fixtures_hold(AVIF_TOOLS, tools["files"])
    log(f"[avif] {len(t_dec)} files with superres, per-block loop filter "
        f"deltas or segment reference features decoded to Pillow's digests "
        f"(avif_tools/expected.json); {len(t_ref)} refused as Pillow "
        f"{tools['made_by']['pillow']} refuses them ({', '.join(t_ref)}); "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    h_dec, h_ref = fixtures_hold(AVIF_HIDDEN, hid["files"])
    flags = host_cpu_flags()
    log(f"[avif] {len(h_dec)} files with hidden frames shown through "
        f"show_existing_frame or with transforms past valid coefficients "
        f"(f11_) decoded to Pillow's digests (avif_hidden/expected.json); "
        f"{len(h_ref)} refused as Pillow {hid['made_by']['pillow']} refuses"
        f" them ({', '.join(h_ref)}); "
        f"{time.perf_counter() - t0:.1f} s; this host's dav1d CPU flags "
        f"{flags}, the fixtures' {hid['made_by']['cpu_flags']}")
    t0 = time.perf_counter()
    i_dec, i_ref = fixtures_hold(AVIF_INTER, itr["files"])
    log(f"[avif] {len(i_dec)} files whose shown frame is an inter frame "
        f"(sequences, layered items, hidden frames) or with f13_ "
        f"transforms decoded to Pillow's digests (avif_inter/expected.json);"
        f" {len(i_ref)} refused as Pillow {itr['made_by']['pillow']} "
        f"refuses them ({', '.join(i_ref)}); "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    walked = [n for n in i_dec if "frames" in itr["files"][n]]
    frames = 0
    for name in walked:
        with open(os.path.join(AVIF_INTER, name), "rb") as f:
            blob = f.read()
        got = []
        try:
            for x in avif.sequence_frames(blob, name):
                got.append(pixel_digest(x))
        except ValueError:
            got.append("refused")
        if got != itr["files"][name]["frames"]:
            raise RuntimeError(f"{name}: frames differ from Pillow's seek(k)")
        frames += len(got)
    log(f"[avif] every frame of the {len(walked)} avif_inter files "
        f"({frames} frames, sequences walked through one dav1d context a "
        f"track) equal to Pillow's seek(k) digests; "
        f"{time.perf_counter() - t0:.1f} s")
    # ---- (b) this host's Pillow on the same files
    paths = {os.path.join(AVIF, n): e.get("sha256", "")
             for n, e in exp["files"].items()}
    for folder, ex in ((AVIF_DEEP, deep), (AVIF_SEQ, seqs),
                       (AVIF_TOOLS, tools), (AVIF_HIDDEN, hid),
                       (AVIF_INTER, itr)):
        paths.update({os.path.join(folder, n): e.get("sha256", "")
                      for n, e in ex["files"].items()})
    run = subprocess.run([sys.executable, "-c", HOST_FILES_SCRIPT,
                          json.dumps(paths)], capture_output=True, text=True,
                         timeout=300)
    if run.returncode == NO_PILLOW:
        log("[avif] this host has no Pillow that imports: its libavif not "
            f"known ({run.stderr.strip()[-200:]})")
    elif run.returncode:
        raise RuntimeError(f"the host's Pillow check failed (exit "
                           f"{run.returncode}): {run.stdout.strip()[-300:]!r}"
                           f" {run.stderr.strip()[-1000:]}")
    else:
        host = json.loads(run.stdout.strip().splitlines()[-1])
        got = host["files"]
        # the f11_ and f13_ files: reported (dav1d's transform code
        # follows the CPU); every other decoded file, the layered items
        # (libavif's choice of layer) among them: held
        f11 = [n for n in h_dec if n.startswith("f11_")]
        f13 = [n for n in i_dec if n.startswith("f13_")]
        layered = [n for n in i_dec if n.startswith("l_")]
        bad = sorted(n for n in decoded + d_dec + s_dec + t_dec +
                     [n for n in h_dec + i_dec if n not in f11 + f13]
                     if got.get(n) != "same")
        if bad:
            raise RuntimeError(f"this host's Pillow {host['pillow']} "
                               f"({host.get('avif')}) decodes "
                               f"{', '.join(bad)} otherwise than "
                               f"expected.json: {[got.get(n) for n in bad]}")
        # a refused file has no digest: "differs" says this Pillow decoded it
        ran = sum(got.get(n) == "differs" for n in refused)
        deep_ran = [n for n in d_ref if not got.get(n, "").startswith(
            "refuses")]
        seq_ran = [n for n in s_ref if not got.get(n, "").startswith(
            "refuses")]
        tools_ran = [n for n in t_ref if not got.get(n, "").startswith(
            "refuses")]
        hid_ran = [n for n in h_ref if not got.get(n, "").startswith(
            "refuses")]
        inter_ran = [n for n in i_ref if not got.get(n, "").startswith(
            "refuses")]
        log(f"[avif] this host's Pillow on the f11_ and f13_ files (its "
            f"dav1d CPU flags {flags}, the fixtures' "
            f"{hid['made_by']['cpu_flags']}): "
            f"{ {n: got.get(n) for n in f11 + f13} } (reported); on the "
            f"hidden frames' {len(h_dec) - len(f11)} and the inter "
            f"frames' {len(i_dec) - len(f13)} other decoded files, the "
            f"{len(layered)} layered items among them: the same (held); "
            f"{len(hid_ran)} of the {len(h_ref)} hidden and "
            f"{len(inter_ran)} of the {len(i_ref)} inter files Pillow "
            f"{hid['made_by']['pillow']} refuses decoded ({hid_ran}, "
            f"{inter_ran}; reported)")
        log(f"[avif] this host's Pillow {host['pillow']} ({host.get('avif')})"
            f" decodes all {len(decoded)} decoded fixtures, the "
            f"{len(d_dec)} decoded 10- and 12-bit ones, the {len(s_dec)} "
            f"decoded sequences and the {len(t_dec)} decoded tools files "
            f"to their digests (held), {ran} of the "
            f"{len(refused)} the port refuses by name, {len(deep_ran)} of "
            f"the {len(d_ref)} deep ones, {len(seq_ran)} of the "
            f"{len(s_ref)} sequences and {len(tools_ran)} of the "
            f"{len(t_ref)} tools files Pillow {deep['made_by']['pillow']} "
            f"refuses ({deep_ran}, {seq_ran}, {tools_ran}; reported)")
    # ---- (c) cli.l3c enc / dec of the two coded files; (d) cli.test
    total = code_and_test(AVIF, exp, "avif", card)
    for folder, ex in ((AVIF_DEEP, deep), (AVIF_SEQ, seqs),
                       (AVIF_TOOLS, tools), (AVIF_HIDDEN, hid),
                       (AVIF_INTER, itr)):
        for k, v in code_and_test(folder, ex, "avif", card,
                                  test=False).items():
            total[k] = total.get(k, 0) + v
    # ---- (e) the host's decode rates of the coded files
    rates = []
    coded = [(AVIF, exp, n) for n in exp["coded"]] + \
        [(AVIF_DEEP, deep, n) for n in deep["coded"]] + \
        [(AVIF_SEQ, seqs, n) for n in seqs["coded"]] + \
        [(AVIF_TOOLS, tools, n) for n in tools["coded"]] + \
        [(AVIF_HIDDEN, hid, n) for n in hid["coded"]] + \
        [(AVIF_INTER, itr, n) for n in itr["coded"]]
    for folder, ex, name in coded:
        e = ex["files"][name]
        blob = open(os.path.join(folder, name), "rb").read()
        dt = math.inf
        for _ in range(3):           # the fastest of three decodes
            t0 = time.perf_counter()
            arr = avif.decode_avif(blob, name)
            dt = min(dt, time.perf_counter() - t0)
        if pixel_digest(arr) != e["sha256"]:
            raise RuntimeError(f"{name}: pixels differ from Pillow's")
        h, w = e["size"]
        rates.append(f"{name} ({w} x {h}, {len(blob)} bytes, "
                     f"{len(blob) * 8 / (h * w):.3f} bits a pixel) "
                     f"{h * w / dt / 1e6:.4f} MP/s ({dt * 1e3:.1f} ms)")
    log(f"[avif] host decode rates, fastest of 3, pixels Pillow's: "
        f"{'; '.join(rates)} | host {cpu}")
    # ---- (f) the default save's decode by stage: the filters' share; the
    # grain save's (the grain stage); the 1024 x 1024 grid's (its cells'
    # stages summed, the assembly); two fixtures that run CDEF and loop
    # restoration; the superres save's (the upscale)
    for folder, ex, name in [(AVIF, exp, n) for n in (
            exp["coded"][2], exp["coded"][3], exp["coded"][4],
            "o_cdef_422.avif", "p_lr_q60_switchable.avif")] + [
                (AVIF_DEEP, deep, deep["coded"][0]),
                (AVIF_TOOLS, tools, tools["coded"][0]),
                (AVIF_HIDDEN, hid, hid["coded"][0]),
                (AVIF_INTER, itr, itr["coded"][0])]:
        blob = open(os.path.join(folder, name), "rb").read()
        ms = avif_stages_ms(blob, name, ex["files"][name]["sha256"])
        filters = ms["deblock"] + ms["cdef"] + ms["restoration"]
        h, w = ex["files"][name]["size"]
        log(f"[avif] {name} ({w} x {h}) by stage, ms, fastest of 3: "
            f"{ {k: round(v, 1) for k, v in ms.items()} }; the in-loop "
            f"filters {filters:.1f} ms = "
            f"{100 * filters / ms['total']:.1f} % of the decode, "
            f"{filters / ms['walk']:.3f} x the symbol walk; the superres "
            f"upscale {ms.get('superres', 0.0):.1f} ms; film grain "
            f"{ms['grain']:.1f} ms = {100 * ms['grain'] / ms['total']:.1f} "
            f"%; a grid's assembly {ms['assemble']:.2f} ms; inter "
            f"prediction {ms['prediction']:.1f} ms = "
            f"{100 * ms['prediction'] / ms['total']:.1f} % | host {cpu}")
    log(f"[avif] launches of the cli.l3c and cli.test calls: "
        f"{({k: v for k, v in total.items() if v})} | {card}")
    return total


def avif_stages_ms(blob, name, digest):
    """An AVIF still's host decode split into the container and headers,
    the symbol walk (intra and inter prediction and transforms included;
    every frame the data holds, a hidden one and a lower layer too, each
    filtered once a later frame predicts from it), the inter prediction
    within it, each in-loop filter of the frame shown, film grain
    synthesis, a grid's assembly of its cells and the YUV to RGB
    conversion (a grid's stages summed over its cells): ms, fastest of 3
    each, and the fastest total; the pixels held to Pillow's digest (an
    RGB file: no alpha to fold in)."""
    from l3c_torch.data import av1_block, av1_obu, avif, avif_yuv
    best = {}
    fd = av1_block.FrameDecoder
    predict = fd._inter_predict
    spent = [0.0]

    def timed_predict(self, b):
        t = time.perf_counter()
        predict(self, b)
        spent[0] += time.perf_counter() - t
    fd._inter_predict = timed_predict
    try:
        for _ in range(3):
            spent[0] = 0.0
            t0 = time.perf_counter()
            m = avif.parse(blob, name)
            grid = m.grids.get(m.primary)
            walks = []
            ctx = av1_obu.context()
            for item in grid.cells if grid else [m.primary]:
                data = avif._item_bytes(blob, m, item, name)
                walks.append(av1_obu.walk_av1(data, name, ctx))
            t1 = time.perf_counter()
            for frames, _ in walks:
                for fr in frames:
                    av1_block.decode_walked(fr, name)
            t2 = time.perf_counter()
            times, cells = {}, []
            for _, shown in walks:
                each = {}
                if shown.planes is None:
                    shown.planes = av1_block.filter_frame(
                        shown.decoder, shown.seq, shown.frame, times=each)
                t_grain = time.perf_counter()
                planes = av1_block.add_grain(shown.planes, shown.seq,
                                             shown.frame)
                each["grain"] = time.perf_counter() - t_grain
                for k, v in each.items():
                    times[k] = times.get(k, 0.0) + v
                cells.append((planes, shown.seq))
            t3 = time.perf_counter()
            planes = avif.assemble(grid, cells, name) if grid else \
                cells[0][0]
            seq = cells[0][1]
            t_rgb = time.perf_counter()
            mc, full_range, cp = avif.colour(m, m.primary, seq)
            rgb = avif_yuv.to_rgb(planes, seq.ssx, seq.ssy, seq.mono, mc,
                                  full_range, name, cp, depth=seq.bit_depth)
            t4 = time.perf_counter()
            for k, v in (("headers", t1 - t0), ("walk", t2 - t1),
                         ("prediction", spent[0]),
                         ("assemble", t_rgb - t3), ("yuv_to_rgb", t4 - t_rgb),
                         ("total", t4 - t0), *times.items()):
                best[k] = min(best.get(k, math.inf), 1e3 * v)
    finally:
        fd._inter_predict = predict
    if pixel_digest(rgb) != digest:
        raise RuntimeError(f"{name}: the staged decode differs")
    return best


def timed(name, fn, *args):
    """fn(*args), its wall time logged."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    numerics_guard()
    card = phase_device()
    cfg = load_ms_config(os.path.join(l3c_cli.default_config_roots()[0],
                                      "ms", "cr.cf"))
    net = MultiscaleNetwork(cfg)
    step = load_network_weights(net, CKPT)
    net = net.cuda().eval()
    n_params = sum(p.numel() for p in net.parameters())
    log(f"[forward] r5b @ step {step}: {n_params}"
        f" params, cr.cf (S=3 Cf=64 8+8 blocks q.C=5 q.L=25 K=10)")
    imgs = bench_images()
    theory = timed("forward", phase_forward, cfg, net, imgs, card)
    bc = TorchBitcoding(cfg, net, device="cuda", coder_profile="balanced",
                        coder_topk=4)
    counts, round_ms = timed("codec", phase_codec, bc, imgs, theory, card)
    recs = timed("kernels", phase_kernels, bc, imgs, counts)
    timed("k6 ragged", phase_k6_ragged, cfg)
    cli_counts = timed("cli", phase_cli, bc, imgs, theory, card)
    timed("profile", phase_profile, bc, imgs, round_ms)
    del bc
    timed("stages", phase_stages, net, cfg, imgs, card)
    timed("sample", phase_sample, ZOO, LOG_DATE, imgs[:2], cfg, card, "r5b")
    timed("serve", phase_serve, cfg, net, imgs, card)
    timed("limits", phase_limits, cfg, card, imgs)
    with tempfile.TemporaryDirectory(prefix="l3c_keep_") as keep:
        train_recs, resumed_dir, resumed_losses = timed(
            "train", phase_train, net, cfg, card, keep)
        recs += train_recs
        for rec in recs:
            rec["cli_launches"] = cli_counts.get(rec["name"], 0)
        base_recs, cr_rgb = timed("baselines", phase_baselines, imgs, card,
                                  keep)
        recs += base_recs
        timed("host", phase_host, cfg, net, imgs, theory, card, resumed_dir,
              cr_rgb)
        bc = TorchBitcoding(cfg, net, device="cuda", coder_profile="balanced",
                            coder_topk=4)
        par_counts = timed("parallel", phase_parallel, cfg, net, bc, imgs,
                           round_ms, card, resumed_dir, resumed_losses)
        for rec in recs:
            rec["parallel_launches"] = par_counts.get(rec["name"], 0)
    prep_counts = timed("prep", phase_prep, cfg, imgs, card)
    synth_counts = timed("synth", phase_synth, cfg, card)
    formats_counts = timed("formats", phase_formats, card)
    damaged_counts = timed("damaged", phase_damaged, card)
    pillow_counts = timed("pillow_formats", phase_pillow_formats, card)
    j2k_counts = timed("jpeg2000", phase_jpeg2000, card)
    registry_counts = timed("registry_formats", phase_registry_formats, card)
    htj2k_counts = timed("htj2k", phase_htj2k, card)
    avif_counts = timed("avif", phase_avif, card)
    for rec in recs:
        rec["prep_launches"] = prep_counts.get(rec["name"], 0)
        rec["synth_launches"] = synth_counts.get(rec["name"], 0)
        rec["formats_launches"] = formats_counts.get(rec["name"], 0)
        rec["damaged_launches"] = damaged_counts.get(rec["name"], 0)
        rec["pillow_formats_launches"] = pillow_counts.get(rec["name"], 0)
        rec["jpeg2000_launches"] = j2k_counts.get(rec["name"], 0)
        rec["registry_formats_launches"] = registry_counts.get(rec["name"],
                                                               0)
        rec["htj2k_launches"] = htj2k_counts.get(rec["name"], 0)
        rec["avif_launches"] = avif_counts.get(rec["name"], 0)
    log(f"[done] {time.perf_counter() - t_start:.1f} s total")
    print(json.dumps({"kernels": recs}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
