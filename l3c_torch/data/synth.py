"""Synthetic photo-statistics source families (zero-egress corpus aid).

Port of `l3c_tpu/data/synth.py`: the same families, the same draws from
the RandomState passed in, in the same order, and the same numpy float64
arithmetic, so a tile is the JAX package's pixel for pixel. Where that
module calls a library the port does not use, it calls its own exact
copy: data/ndimage.py for scipy.ndimage's map_coordinates and
gaussian_filter, data/resample.py for Pillow's bicubic resize, and
data/jpeg_encode.py + data/jpeg.decode_jpeg for Pillow's JPEG round trip.
All of it runs on the host, as in JAX: no device computes any of it.

The round-3 family-count ablation (RESULTS.md) showed held-out bpsp
improves monotonically with the number of DISTINCT source families at a
fixed image budget — the 23-source offline corpus, not the framework,
is the flagship's generalization ceiling. With no photo corpus
available offline, this module manufactures additional *families*:
procedural generators whose outputs share natural images' second-order
statistics (≈1/f^2 power spectra, strong cross-channel correlation,
piecewise-smooth regions separated by sharp edges, sensor noise) while
each family keeps its own distinctive higher-order structure, exactly
like distinct photographic sources do.

Counterpart of the reference's unbounded Open Images download
(prep_openimages.sh:39-53) in spirit: more independent sources. Use via
`prep_pipeline --synth_families` or `generate_families` directly; tiles are
uint8 RGB, ready for `build_corpus(extra_train_dirs=[...])`.

All generators are pure numpy (one host core): FFT-filtered noise and
closed-form fields only.
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, List

import numpy as np

from .images import write_png
from .jpeg import decode_jpeg
from .jpeg_encode import encode_jpeg
from .ndimage import gaussian_filter, map_coordinates
from .resample import resize


def _rgb_mix(rng: np.random.RandomState, fields: np.ndarray,
             sat: float = 1.0) -> np.ndarray:
    """Mix ≥1 scalar fields (k, h, w) into correlated RGB in [0, 1].

    Natural photos have highly correlated channels (luma dominates);
    draw a random luma direction plus small chroma components."""
    k = fields.shape[0]
    luma = rng.uniform(0.7, 1.0, (1, 3))
    chroma = rng.normal(0.0, 0.25 * sat, (k, 3))
    chroma[0] *= 0.0
    m = luma + chroma                                    # (k, 3)
    rgb = np.tensordot(fields, m, axes=(0, 0))           # (h, w, 3)
    lo, hi = np.percentile(rgb, [1, 99])
    rgb = (rgb - lo) / max(hi - lo, 1e-6)
    return np.clip(rgb, 0.0, 1.0)


def _spectral_noise(rng: np.random.RandomState, n: int, alpha: float,
                    aniso: float = 0.0, theta: float = 0.0
                    ) -> np.ndarray:
    """Gaussian noise shaped to a 1/f^alpha amplitude spectrum.

    aniso stretches the spectral falloff along direction theta
    (anisotropic textures: wood grain, brushed metal, water)."""
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.rfftfreq(n)[None, :]
    if aniso:
        c, s = np.cos(theta), np.sin(theta)
        fu = fx * c + fy * s
        fv = -fx * s + fy * c
        f = np.sqrt((fu * (1 + aniso)) ** 2 + fv ** 2)
    else:
        f = np.sqrt(fx ** 2 + fy ** 2)
    f_safe = np.where(f > 0, f, 1.0)
    amp = np.where(f > 0, f_safe ** (-alpha / 2.0), 0.0)
    spec = (rng.normal(size=(n, n // 2 + 1))
            + 1j * rng.normal(size=(n, n // 2 + 1))) * amp
    x = np.fft.irfft2(spec, s=(n, n))
    return (x - x.mean()) / (x.std() + 1e-9)


def _smooth01(x: np.ndarray) -> np.ndarray:
    lo, hi = x.min(), x.max()
    return (x - lo) / max(hi - lo, 1e-9)


def _fam_spectral(rng, n):
    """Pure 1/f^alpha color noise — the photographic power-spectrum
    prior with no object structure."""
    a = rng.uniform(1.6, 2.4)
    fields = np.stack([_spectral_noise(rng, n, a) for _ in range(3)])
    return _rgb_mix(rng, fields)


def _fam_terrain(rng, n):
    """Ridged fBm: |1/f^2 noise| creases look like rock/terrain."""
    base = _spectral_noise(rng, n, rng.uniform(1.9, 2.3))
    ridged = 1.0 - np.abs(base) / (np.abs(base).max() + 1e-9)
    detail = _spectral_noise(rng, n, 1.2) * 0.15
    return _rgb_mix(rng, np.stack([ridged, detail, base * 0.3]))


def _fam_aniso(rng, n):
    """Anisotropic grain (wood / brushed metal / water)."""
    th = rng.uniform(0, np.pi)
    g = _spectral_noise(rng, n, rng.uniform(1.5, 2.0),
                        aniso=rng.uniform(4.0, 12.0), theta=th)
    rings = np.sin(g * rng.uniform(2, 6)
                   + _spectral_noise(rng, n, 2.5) * 2.0)
    return _rgb_mix(rng, np.stack([g, rings * 0.4]), sat=0.6)


def _fam_cells(rng, n):
    """Voronoi-like cellular regions: piecewise-smooth patches with
    sharp boundaries (object-edge statistics)."""
    k = rng.randint(12, 40)
    cy = rng.uniform(0, n, k)
    cx = rng.uniform(0, n, k)
    yy, xx = np.mgrid[0:n, 0:n]
    d = ((yy[None] - cy[:, None, None]) ** 2
         + (xx[None] - cx[:, None, None]) ** 2)
    idx = np.argmin(d, axis=0)
    vals = rng.uniform(0, 1, k)
    field = vals[idx]
    shade = _spectral_noise(rng, n, 2.0) * 0.25
    d1 = np.sort(d, axis=0)
    edge = np.sqrt(d1[1]) - np.sqrt(d1[0])          # ridge distance
    edge = np.exp(-edge / rng.uniform(1.0, 4.0)) * 0.5
    return _rgb_mix(rng, np.stack([field, shade, -edge]))


def _fam_shapes(rng, n):
    """Layered soft-edged discs/rectangles with gradient lighting —
    man-made-scene statistics (flat regions, straight edges)."""
    img = np.zeros((n, n))
    yy, xx = np.mgrid[0:n, 0:n]
    grad = (yy * rng.normal(0, 1) + xx * rng.normal(0, 1)) / n
    img += grad
    for _ in range(rng.randint(6, 18)):
        cy, cx = rng.uniform(0, n, 2)
        r = rng.uniform(0.05, 0.4) * n
        soft = rng.uniform(0.5, 6.0)
        if rng.rand() < 0.5:
            m = 1 / (1 + np.exp((np.hypot(yy - cy, xx - cx) - r) / soft))
        else:
            m = (1 / (1 + np.exp((np.abs(yy - cy) - r) / soft))
                 * 1 / (1 + np.exp((np.abs(xx - cx) - r * rng.uniform(
                     0.3, 3.0)) / soft)))
        img = img * (1 - 0.8 * m) + m * rng.uniform(-1, 1)
    tex = _spectral_noise(rng, n, 1.8) * 0.1
    return _rgb_mix(rng, np.stack([img, tex]))


def _fam_sky(rng, n):
    """Smooth vertical gradient + low-frequency clouds (sky/sea)."""
    yy = np.linspace(-1, 1, n)[:, None] * np.ones((1, n))
    clouds = _spectral_noise(rng, n, rng.uniform(2.4, 3.0))
    haze = _spectral_noise(rng, n, 2.0) * 0.2
    return _rgb_mix(rng, np.stack([yy * rng.uniform(0.5, 1.5),
                                   np.maximum(clouds, 0), haze]),
                    sat=1.4)


def _fam_bokeh(rng, n):
    """Out-of-focus photo statistics: blurred bright discs over a
    smooth dark field."""
    img = _spectral_noise(rng, n, 2.2) * 0.2 - 0.5
    yy, xx = np.mgrid[0:n, 0:n]
    for _ in range(rng.randint(8, 30)):
        cy, cx = rng.uniform(0, n, 2)
        r = rng.uniform(0.02, 0.12) * n
        m = 1 / (1 + np.exp((np.hypot(yy - cy, xx - cx) - r)
                            / rng.uniform(1.5, 5.0)))
        img += m * rng.uniform(0.3, 1.2)
    return _rgb_mix(rng, np.stack([img]), sat=1.6)


def _fam_waves(rng, n):
    """Interfering sinusoids (fabric weave / ripples / moire)."""
    yy, xx = np.mgrid[0:n, 0:n]
    img = np.zeros((n, n))
    for _ in range(rng.randint(2, 5)):
        fy, fx = rng.uniform(-0.15, 0.15, 2)
        img += np.sin(2 * np.pi * (fy * yy + fx * xx)
                      + rng.uniform(0, 2 * np.pi)) * rng.uniform(.3, 1)
    warp = _spectral_noise(rng, n, 2.0)
    return _rgb_mix(rng, np.stack([img, warp * 0.4]), sat=0.5)


def _fam_grain(rng, n):
    """Fine high-frequency grain over a near-flat base (paper, skin,
    plaster) — trains the fine-scale sensor-noise regime."""
    base = _spectral_noise(rng, n, 2.6) * 0.3
    grain = _spectral_noise(rng, n, rng.uniform(0.3, 0.8)) * \
        rng.uniform(0.1, 0.35)
    return _rgb_mix(rng, np.stack([base, grain]), sat=0.4)


def _fam_patch_mosaic(rng, n):
    """Axis-aligned panels with distinct textures (buildings,
    documents, collages): hard straight edges + per-region stats."""
    img = _spectral_noise(rng, n, 2.0)
    for _ in range(rng.randint(3, 8)):
        y0, x0 = rng.randint(0, n - 8, 2)
        h = rng.randint(8, n - y0)
        w = rng.randint(8, n - x0)
        a = rng.uniform(1.0, 2.8)
        img[y0:y0 + h, x0:x0 + w] = (
            _spectral_noise(rng, n, a)[:h, :w] * rng.uniform(0.3, 1.0)
            + rng.uniform(-1, 1))
    return _rgb_mix(rng, np.stack([img]))


def _fam_dof(rng, n):
    """Depth-of-field composite: a sharp textured region over a heavily
    low-passed background — spatially VARYING sharpness, the one photo
    statistic no single-spectrum family has."""
    sharp = _spectral_noise(rng, n, rng.uniform(1.2, 1.8))
    blurred = _spectral_noise(rng, n, rng.uniform(2.8, 3.4))
    # smooth focus mask: thresholded very-low-frequency field
    m = _smooth01(_spectral_noise(rng, n, 3.5))
    m = 1 / (1 + np.exp(-(m - rng.uniform(0.35, 0.65)) * 20))
    img = sharp * m + blurred * (1 - m)
    return _rgb_mix(rng, np.stack([img, m - 0.5]))


def _fam_text(rng, n):
    """Document statistics: rows of short dark strokes on a flat light
    page — extreme bimodal histogram + axis-aligned high-frequency
    structure (scans, signs, screenshots-with-text)."""
    img = np.full((n, n), rng.uniform(0.85, 1.0))
    row_h = rng.randint(6, 14)
    y = rng.randint(2, row_h)
    ink = rng.uniform(0.0, 0.25)
    while y + row_h < n:
        x = rng.randint(0, 8)
        glyph_h = max(2, int(row_h * rng.uniform(0.5, 0.8)))
        while x < n - 2:
            w = rng.randint(2, 14)                     # word segment
            if rng.rand() < 0.8:
                img[y:y + glyph_h, x:min(x + w, n)] = \
                    ink + rng.uniform(0, 0.15)
            x += w + rng.randint(1, 5)                 # letter/word gap
        y += row_h
    # slight page shading + print noise keep it photographic
    shade = _spectral_noise(rng, n, 2.5) * 0.05
    return _rgb_mix(rng, np.stack([img + shade]), sat=0.15)


def _fam_foliage(rng, n):
    """Vegetation: clumped multi-scale blobs with hard silhouettes and
    fine inner texture (leaves/grass against sky gaps)."""
    clumps = _spectral_noise(rng, n, 2.2)
    leaves = _spectral_noise(rng, n, 1.0) * 0.6
    mask = 1 / (1 + np.exp(-(clumps - rng.uniform(-0.3, 0.3)) * 8))
    gaps = _smooth01(_spectral_noise(rng, n, 3.0))     # sky behind
    img = mask * (0.3 + leaves * 0.4) + (1 - mask) * (0.7 + gaps * 0.3)
    return _rgb_mix(rng, np.stack([img, mask - 0.5, leaves * mask]))


def _fam_marble(rng, n):
    """Warped-coordinate veins: sin(k·u + fBm warp) — marble, agate,
    wood figure; thin curvilinear high-contrast features."""
    yy, xx = np.mgrid[0:n, 0:n]
    th = rng.uniform(0, np.pi)
    u = (np.cos(th) * xx + np.sin(th) * yy) / n
    warp = _spectral_noise(rng, n, 2.2) * rng.uniform(1.0, 3.0)
    veins = np.sin(2 * np.pi * u * rng.uniform(2, 8) + warp)
    sharp = np.abs(veins) ** rng.uniform(0.3, 0.8) * np.sign(veins)
    base = _spectral_noise(rng, n, 2.6) * 0.3
    return _rgb_mix(rng, np.stack([sharp, base]), sat=0.5)


def _fam_vector(rng, n):
    """Flat vector art / UI: a few EXACTLY uniform or linear-gradient
    polygons with hard anti-aliased edges and zero sensor noise — the
    run-length regime real screenshots live in."""
    img = np.full((n, n), rng.uniform(0, 1))
    yy, xx = np.mgrid[0:n, 0:n]
    for _ in range(rng.randint(4, 12)):
        # random half-plane pair -> convex strip/wedge regions
        a, b = rng.normal(0, 1, 2)
        c = rng.uniform(-0.5, 0.5) * n
        d = (a * (xx - n / 2) + b * (yy - n / 2) - c) \
            / max(np.hypot(a, b), 1e-6)
        m = np.clip(0.5 - d, 0, 1)                     # 1px AA edge
        if rng.rand() < 0.3:                            # gradient fill
            fill = _smooth01(rng.normal(0, 1) * xx + rng.normal(0, 1)
                             * yy) * rng.uniform(0.5, 1.0)
        else:                                           # flat fill
            fill = rng.uniform(0, 1)
        keep = rng.uniform(0.6, 1.0)
        img = img * (1 - m * keep) + fill * m * keep
    return _rgb_mix(rng, np.stack([img]), sat=0.8)


def _fam_print(rng, n):
    """Periodic printed patterns (fabric, wallpaper, halftone): a
    warped 2-D lattice of repeated motifs."""
    yy, xx = np.mgrid[0:n, 0:n]
    py, px = rng.uniform(0.04, 0.2, 2)
    wy = _spectral_noise(rng, n, 2.4) * rng.uniform(0, 2)
    wx = _spectral_noise(rng, n, 2.4) * rng.uniform(0, 2)
    u = np.sin(2 * np.pi * py * yy + wy)
    v = np.sin(2 * np.pi * px * xx + wx)
    motif = u * v if rng.rand() < 0.5 else np.maximum(u, v)
    if rng.rand() < 0.4:                               # halftone dots
        motif = np.where(motif > rng.uniform(-0.3, 0.3), 1.0, -1.0)
    tex = _spectral_noise(rng, n, 1.8) * 0.15
    return _rgb_mix(rng, np.stack([motif, tex]), sat=0.7)


def _fam_vignette(rng, n):
    """Portrait/lens lighting: smooth radial illumination falloff over
    a gently textured subject — large-scale multiplicative shading."""
    yy, xx = np.mgrid[0:n, 0:n]
    cy, cx = rng.uniform(0.25 * n, 0.75 * n, 2)
    r = np.hypot(yy - cy, xx - cx) / n
    light = np.exp(-(r ** 2) * rng.uniform(2.0, 6.0))
    subject = _spectral_noise(rng, n, 2.3) * 0.4 + 0.5
    img = subject * (0.2 + 0.8 * light)
    return _rgb_mix(rng, np.stack([img, light - 0.5]), sat=0.9)


def _fam_night(rng, n):
    """Low-light scene: near-black base, strong sensor noise, sparse
    saturated point/streak lights — the high-noise dark regime."""
    base = np.abs(_spectral_noise(rng, n, 2.4)) * 0.08
    yy, xx = np.mgrid[0:n, 0:n]
    lights = np.zeros((n, n))
    for _ in range(rng.randint(5, 25)):
        cy, cx = rng.uniform(0, n, 2)
        sy = rng.uniform(0.8, 3.0)
        sx = sy * rng.uniform(1.0, 8.0) if rng.rand() < 0.3 else sy
        lights += np.exp(-(((yy - cy) / sy) ** 2
                           + ((xx - cx) / sx) ** 2)) \
            * rng.uniform(0.5, 1.5)
    img = base + lights
    out = _rgb_mix(rng, np.stack([img, lights]), sat=1.8)
    return out * rng.uniform(0.5, 0.85)        # keep it dark post-norm


def _jpeg_roundtrip(u8: np.ndarray, quality: int) -> np.ndarray:
    """Round-trip a uint8 RGB tile through JPEG at `quality`.

    The reference's Open Images corpus is JPEG-sourced end to end
    (prep_openimages.sh downloads .jpg dumps), so every training pixel
    the reference model sees carries 8x8 DCT block artifacts. Our
    package/procedural sources are artifact-free; this injects that
    statistic.

    Pillow's save(format="JPEG", quality=q), then Image.open().convert(
    "RGB"): encode_jpeg writes Pillow's bytes and decode_jpeg reads them
    as Pillow does (saturating, as Pillow's SIMD inverse DCT, a block
    outside the range its C and SIMD code agree on)."""
    return decode_jpeg(encode_jpeg(u8, int(quality)), "<synth JPEG>")


def _camera_degrade(u8: np.ndarray, rng: np.random.RandomState
                    ) -> np.ndarray:
    """Physically-motivated sensor noise: gamma-decode to linear light,
    Poisson shot noise (variance proportional to signal) + Gaussian read
    noise, gamma-encode back. Unlike the uniform +-k augmentation, the
    noise level depends on brightness exactly as in real photos (dark
    regions noisier after gamma), which is the statistic a conditional
    density model actually has to calibrate to."""
    gamma = 2.2
    lin = (u8.astype(np.float64) / 255.0) ** gamma
    # full-well capacity in photoelectrons: low = high-ISO noisy shot
    fw = float(rng.uniform(200.0, 4000.0))
    read = float(rng.uniform(0.5, 3.0))             # e- read noise
    e = rng.poisson(lin * fw) + rng.normal(0.0, read, lin.shape)
    lin_n = np.clip(e / fw, 0.0, 1.0)
    out = (lin_n ** (1.0 / gamma)) * 255.0 + 0.5
    return out.astype(np.uint8)


def _fam_multiscale(rng, n):
    """True multi-scale mixture: coarse structure from one family
    rendered at n/4 and bicubic-upsampled, fine detail from ANOTHER
    family, blended through a smooth spatial mask. No single-generator
    family produces content whose statistics CHANGE with scale the way
    photos do (objects at low freq, texture at high freq); this one
    does, by construction."""
    coarse_fams = [_fam_shapes, _fam_cells, _fam_sky, _fam_terrain]
    fine_fams = [_fam_grain, _fam_aniso, _fam_waves, _fam_foliage,
                 _fam_marble]
    coarse = coarse_fams[rng.randint(len(coarse_fams))](rng, n // 4)
    coarse = resize((coarse * 255).astype(np.uint8), (n, n), "bicubic"
                    ).astype(np.float64) / 255.0
    fine = fine_fams[rng.randint(len(fine_fams))](rng, n)
    amount = rng.uniform(0.15, 0.5)
    m = _smooth01(_spectral_noise(rng, n, 3.0))[..., None]
    mix = coarse * (1 - amount * m) + fine * (amount * m)
    return np.clip(mix, 0.0, 1.0)


def _fam_jpegtex(rng, n):
    """Compression-artifact texture: sharp-structured content pushed
    through aggressive JPEG so 8x8 block boundaries, DCT ringing and
    chroma bleeding BECOME the dominant statistic (thumbnails, memes,
    re-shared web photos)."""
    base_fams = [_fam_shapes, _fam_text, _fam_vector, _fam_cells,
                 _fam_foliage]
    rgb = base_fams[rng.randint(len(base_fams))](rng, n)
    u8 = (rgb * 255.0 + 0.5).astype(np.uint8)
    u8 = _jpeg_roundtrip(u8, rng.randint(8, 40))
    if rng.rand() < 0.3:                    # double-compressed re-share
        u8 = _jpeg_roundtrip(u8, rng.randint(30, 70))
    return u8.astype(np.float64) / 255.0


def _fam_camnoise(rng, n):
    """Low-light camera capture: smooth scene content whose visible
    texture IS the sensor noise (shot + read, signal-dependent).
    Complements `night` (which is about sparse lights) by making the
    noise field itself the family's structure."""
    scene_fams = [_fam_sky, _fam_vignette, _fam_dof, _fam_bokeh]
    rgb = scene_fams[rng.randint(len(scene_fams))](rng, n)
    rgb = rgb * rng.uniform(0.25, 0.7)        # underexpose
    u8 = (rgb * 255.0 + 0.5).astype(np.uint8)
    return _camera_degrade(u8, rng).astype(np.float64) / 255.0


def _fam_layers(rng, n):
    """Occlusion-depth composite: textured blobs stacked with hard
    silhouettes and soft drop shadows over a smooth background — the
    object-over-object statistic (occlusion boundaries whose two sides
    carry UNRELATED textures, plus correlated shadow luminance) that no
    single-field family produces."""
    yy, xx = np.mgrid[0:n, 0:n]
    bg = _rgb_mix(rng, np.stack([_spectral_noise(rng, n, 2.4)]))
    fills = [_fam_grain, _fam_aniso, _fam_marble, _fam_waves,
             _fam_spectral]
    rgb = bg
    for _ in range(rng.randint(3, 7)):
        cy, cx = rng.uniform(0.1 * n, 0.9 * n, 2)
        r0 = rng.uniform(0.12, 0.35) * n
        wob = _spectral_noise(rng, n, 2.8) * rng.uniform(0.1, 0.35)
        r = np.hypot(yy - cy, xx - cx)
        m = 1 / (1 + np.exp((r - r0 * (1 + wob)) / rng.uniform(0.6, 2.0)))
        # drop shadow: the SAME mask shifted along the light direction
        dy, dx = rng.randint(3, 12), rng.randint(3, 12)
        sh = np.roll(np.roll(m, dy, axis=0), dx, axis=1)
        rgb = rgb * (1 - 0.45 * sh[..., None] * (1 - m[..., None]))
        fill = fills[rng.randint(len(fills))](rng, n)
        rgb = rgb * (1 - m[..., None]) + fill * m[..., None]
    return np.clip(rgb, 0.0, 1.0)


def _fam_specular(rng, n):
    """Glossy surface: matte base + sparse NARROW saturated highlights
    (specular lobes crush to the white point in real photos — a heavy
    right-tail luminance statistic with hard clipping)."""
    base = _rgb_mix(rng, np.stack([_spectral_noise(rng, n, 2.2)]),
                    sat=0.7) * rng.uniform(0.4, 0.7)
    bump = _spectral_noise(rng, n, rng.uniform(1.6, 2.2))
    q = np.percentile(bump, rng.uniform(90, 98))
    spec = 1 / (1 + np.exp(-(bump - q) * rng.uniform(6, 20)))
    tint = np.array([1.0, rng.uniform(0.9, 1.0), rng.uniform(0.85, 1.0)])
    return np.clip(base + spec[..., None] * tint * rng.uniform(0.8, 1.6),
                   0.0, 1.0)


def _fam_perspective(rng, n):
    """Ground-plane texture under perspective: texture scale GROWS
    towards the horizon (roads, floors, fields) with a sky band above —
    a spatially varying power spectrum tied to image y, which every
    stationary generator lacks."""
    tex = _spectral_noise(rng, n, rng.uniform(1.4, 2.0))
    horizon = rng.uniform(0.15, 0.45) * n
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    # pinhole ground projection: depth ~ 1/(y - horizon)
    d = np.maximum(yy - horizon, 1e-3)
    scale = rng.uniform(20.0, 80.0)
    v = (scale * n / d) % n
    u = ((xx - n / 2) * (scale * 4 / d) + n / 2) % n
    ground = map_coordinates(tex, [v, u], order=1, mode="wrap")
    # atmospheric fade towards the horizon + sky gradient above it
    fade = np.clip((yy - horizon) / (n - horizon + 1e-6), 0, 1)
    sky = 0.7 + 0.25 * (1 - yy / max(horizon, 1.0)) \
        + _spectral_noise(rng, n, 2.8) * 0.05
    g = np.where(yy < horizon, sky, ground * (0.3 + 0.7 * fade))
    shade = _spectral_noise(rng, n, 2.6) * 0.15
    return _rgb_mix(rng, np.stack([g, shade]))


def _fam_caustics(rng, n):
    """Underwater caustics: thin bright curvilinear webs over a cool
    base — sparse high-contrast ridge networks (also reads as lightning,
    cracks, vein networks)."""
    w1 = _spectral_noise(rng, n, 2.4) * rng.uniform(1.5, 3.0)
    w2 = _spectral_noise(rng, n, 2.4) * rng.uniform(1.5, 3.0)
    p = rng.uniform(1.5, 4.0)
    web = ((1 - np.abs(np.sin(w1 * np.pi))) ** p
           * (1 - np.abs(np.sin(w2 * np.pi))) ** p)
    depth = _spectral_noise(rng, n, 3.0) * 0.3
    base = _rgb_mix(rng, np.stack([depth]), sat=1.2) \
        * np.array([rng.uniform(0.1, 0.4), rng.uniform(0.4, 0.7),
                    rng.uniform(0.5, 0.9)])
    return np.clip(base + web[..., None] * rng.uniform(0.5, 1.0), 0, 1)


def _fam_strands(rng, n):
    """Fur / grass-blade statistics: fine streaks whose ORIENTATION
    varies smoothly across the image (aniso covers one global direction;
    real pelts and meadows swirl)."""
    angles = [0.0, np.pi / 3, 2 * np.pi / 3]
    streaks = np.stack([
        _spectral_noise(rng, n, rng.uniform(1.2, 1.6),
                        aniso=rng.uniform(8.0, 16.0), theta=a)
        for a in angles])
    sel = np.stack([_spectral_noise(rng, n, 3.0) for _ in angles])
    w = np.exp(sel * rng.uniform(2.0, 4.0))
    w /= w.sum(0, keepdims=True)
    fur = (streaks * w).sum(0)
    shade = _spectral_noise(rng, n, 2.6) * 0.5
    return _rgb_mix(rng, np.stack([fur, shade]), sat=0.5)


def _fam_clutter(rng, n):
    """Piles of similar small objects (gravel, berries, crowds): many
    shaded ellipses from a small colour palette — repeated-object
    statistics at a consistent scale with occlusion."""
    yy, xx = np.mgrid[0:n, 0:n]
    bg = _rgb_mix(rng, np.stack([_spectral_noise(rng, n, 2.0)])) * 0.5
    pal = rng.uniform(0.1, 0.9, (rng.randint(2, 4), 3))
    rgb = bg
    ly, lx = rng.normal(0, 1, 2)
    nrm = max(np.hypot(ly, lx), 1e-6)
    ly, lx = ly / nrm, lx / nrm
    r_base = rng.uniform(0.02, 0.06) * n
    for _ in range(rng.randint(40, 120)):
        cy, cx = rng.uniform(0, n, 2)
        ry = r_base * rng.uniform(0.6, 1.5)
        rx = ry * rng.uniform(0.7, 1.4)
        d2 = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        m = 1 / (1 + np.exp(np.clip((d2 - 1.0) * rng.uniform(4, 12),
                                    -60.0, 60.0)))
        lam = ((yy - cy) * ly + (xx - cx) * lx) / max(ry, rx)
        shade = np.clip(0.75 - 0.35 * lam, 0.2, 1.2)
        col = np.clip(pal[rng.randint(len(pal))]
                      + rng.normal(0, 0.06, 3), 0, 1)
        rgb = rgb * (1 - m[..., None]) \
            + (col * shade[..., None]) * m[..., None]
    grain = _spectral_noise(rng, n, 1.0) * 0.04
    return np.clip(rgb + grain[..., None], 0, 1)


def _fam_weathered(rng, n):
    """Rust / peeling paint: a flat painted base invaded by blotches of
    rough differently-coloured texture with crisp irregular borders —
    multiplicative patchiness over man-made surfaces."""
    blotch = _spectral_noise(rng, n, rng.uniform(2.2, 2.8))
    t = rng.uniform(-0.4, 0.6)
    m = 1 / (1 + np.exp(-(blotch - t) * rng.uniform(6, 16)))
    paint = np.clip(np.array([rng.uniform(0.3, 0.9) for _ in range(3)])
                    + _spectral_noise(rng, n, 2.8)[..., None] * 0.05,
                    0, 1)
    rough = _smooth01(_spectral_noise(rng, n, 1.2))
    rust_col = np.array([rng.uniform(0.35, 0.7), rng.uniform(0.15, 0.4),
                         rng.uniform(0.05, 0.25)])
    rust = rust_col * (0.5 + rough[..., None] * 0.8)
    rim = np.abs(np.gradient(m)[0]) + np.abs(np.gradient(m)[1])
    rgb = paint * (1 - m[..., None]) + rust * m[..., None]
    rgb = rgb * (1 - np.clip(rim * 2, 0, 0.5))[..., None]
    return np.clip(rgb, 0, 1)


def _fam_bricks(rng, n):
    """Brick/tile lattice: a regular grid with per-cell colour jitter,
    thin dark mortar lines and slight coordinate warp — periodic
    man-made structure with stochastic per-cell content."""
    bh = rng.randint(14, 30)
    bw = int(bh * rng.uniform(1.8, 3.0))
    mortar = rng.randint(1, 4)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    warp = _spectral_noise(rng, n, 2.6) * rng.uniform(0.0, 2.0)
    yw, xw = yy + warp, xx + warp
    row = np.floor(yw / bh).astype(int)
    xoff = xw + (row % 2) * (bw // 2)
    col = np.floor(xoff / bw).astype(int)
    vals = rng.uniform(0.25, 0.95, (n // 8 + 4, n // 8 + 4))
    cell = vals[row % vals.shape[0], col % vals.shape[1]]
    fy = yw - row * bh
    fx = xoff - col * bw
    is_mortar = (fy < mortar) | (fx < mortar)
    tex = _spectral_noise(rng, n, 1.6) * 0.08
    g = np.where(is_mortar, rng.uniform(0.05, 0.3), cell) + tex
    shade = _spectral_noise(rng, n, 2.8) * 0.2
    return _rgb_mix(rng, np.stack([g, shade]), sat=0.6)


def _fam_aberration(rng, n):
    """Lens-imperfection composite: chromatic aberration (per-channel
    radial magnification) and slight motion blur applied to structured
    content — channel-DISPLACED edges, a real-camera statistic every
    clean generator lacks."""
    base_fams = [_fam_shapes, _fam_cells, _fam_patch_mosaic, _fam_text,
                 _fam_foliage]
    rgb = base_fams[rng.randint(len(base_fams))](rng, n)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    cyx = n / 2.0
    out = np.empty_like(rgb)
    ca = rng.uniform(0.002, 0.012)
    for c, s in enumerate((1 - ca, 1.0, 1 + ca)):
        out[..., c] = map_coordinates(
            rgb[..., c], [(yy - cyx) * s + cyx, (xx - cyx) * s + cyx],
            order=1, mode="reflect")
    if rng.rand() < 0.6:                       # short motion blur
        k = rng.randint(2, 6)
        th = rng.uniform(0, np.pi)
        acc = np.zeros_like(out)
        for i in range(k):
            dy = int(round(np.sin(th) * i))
            dx = int(round(np.cos(th) * i))
            acc += np.roll(np.roll(out, dy, axis=0), dx, axis=1)
        out = acc / k
    return np.clip(out, 0, 1)


def _fam_posterize(rng, n):
    """Banded gradients: smooth shading quantized to few levels (web
    graphics, cartoons, over-compressed skies) — long exact-run regions
    separated by single-step contours."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64) / n
    g = (rng.normal(0, 1) * yy + rng.normal(0, 1) * xx
         + rng.uniform(1, 3) * np.hypot(yy - rng.rand(), xx - rng.rand())
         + _spectral_noise(rng, n, 3.2) * rng.uniform(0.0, 0.3))
    g = _smooth01(g)
    levels = rng.randint(4, 24)
    if rng.rand() < 0.4:                       # ordered (Bayer) dither
        bayer = np.array([[0, 8, 2, 10], [12, 4, 14, 6],
                          [3, 11, 1, 9], [15, 7, 13, 5]]) / 16.0 - 0.5
        g = g + np.tile(bayer, (n // 4 + 1, n // 4 + 1))[:n, :n] / levels
    q = np.floor(np.clip(g, 0, 0.999) * levels) / (levels - 1)
    cols = rng.uniform(0, 1, (2, 3))
    rgb = cols[0] * (1 - q[..., None]) + cols[1] * q[..., None]
    return np.clip(rgb, 0, 1)


def _fam_fisheye(rng, n):
    """Wide-angle geometric distortion of structured content: straight
    edges become curves with a radially varying local scale."""
    base_fams = [_fam_bricks, _fam_patch_mosaic, _fam_text, _fam_waves,
                 _fam_vector]
    rgb = base_fams[rng.randint(len(base_fams))](rng, n)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    cy = n / 2 + rng.uniform(-0.2, 0.2) * n
    cx = n / 2 + rng.uniform(-0.2, 0.2) * n
    r = np.hypot(yy - cy, xx - cx) / n
    k = rng.uniform(-0.8, 1.5)
    f = 1 + k * r * r
    out = np.stack([map_coordinates(rgb[..., c],
                                    [(yy - cy) * f + cy,
                                     (xx - cx) * f + cx],
                                    order=1, mode="reflect")
                    for c in range(3)], axis=-1)
    return np.clip(out, 0, 1)


def _fam_hdrclip(rng, n):
    """Backlit interior: dim textured room against blown-out window
    regions clipped at the white point with bloom — the bimodal
    luminance + saturation-clipping statistic of real HDR scenes."""
    room = _rgb_mix(rng, np.stack([_spectral_noise(rng, n, 2.1),
                                   _spectral_noise(rng, n, 1.4) * 0.3])
                    ) * rng.uniform(0.15, 0.4)
    yy, xx = np.mgrid[0:n, 0:n]
    win = np.zeros((n, n))
    for _ in range(rng.randint(1, 4)):
        y0, x0 = rng.randint(0, n // 2, 2)
        h = rng.randint(n // 5, n // 2)
        w = rng.randint(n // 6, n // 2)
        soft = rng.uniform(0.5, 2.0)
        win += (1 / (1 + np.exp((np.abs(yy - y0 - h / 2) - h / 2) / soft))
                * 1 / (1 + np.exp((np.abs(xx - x0 - w / 2) - w / 2)
                                  / soft)))
    win = np.clip(win, 0, 1)
    glow = gaussian_filter(win, rng.uniform(4, 12)) * rng.uniform(.2, .5)
    hot = win * rng.uniform(1.2, 2.5)           # >1 clips to white
    return np.clip(room + hot[..., None] + glow[..., None], 0, 1)


FAMILIES: Dict[str, Callable] = {
    "spectral": _fam_spectral,
    "terrain": _fam_terrain,
    "aniso": _fam_aniso,
    "cells": _fam_cells,
    "shapes": _fam_shapes,
    "sky": _fam_sky,
    "bokeh": _fam_bokeh,
    "waves": _fam_waves,
    "grain": _fam_grain,
    "mosaic": _fam_patch_mosaic,
    # round-3 session-3 additions: statistics the first ten don't span
    "dof": _fam_dof,
    "text": _fam_text,
    "foliage": _fam_foliage,
    "marble": _fam_marble,
    "vector": _fam_vector,
    "print": _fam_print,
    "vignette": _fam_vignette,
    "night": _fam_night,
    # round-4 additions (VERDICT item 7): the three statistics the
    # eighteen above still don't span
    "multiscale": _fam_multiscale,
    "jpegtex": _fam_jpegtex,
    "camnoise": _fam_camnoise,
    # round-5 additions (VERDICT item 1: keep converting family
    # diversity into held-out generalization): statistics the
    # twenty-one above still don't span
    "layers": _fam_layers,
    "specular": _fam_specular,
    "perspective": _fam_perspective,
    "caustics": _fam_caustics,
    "strands": _fam_strands,
    "clutter": _fam_clutter,
    "weathered": _fam_weathered,
    "bricks": _fam_bricks,
    "aberration": _fam_aberration,
    "posterize": _fam_posterize,
    "fisheye": _fam_fisheye,
    "hdrclip": _fam_hdrclip,
}


def render_tile(family: str, rng: np.random.RandomState,
                n: int = 256, noise_frac: float = 0.5) -> np.ndarray:
    """One uint8 RGB tile of a family, with sensor-noise augmentation
    matching offline_corpus._tiles_from's policy."""
    rgb = FAMILIES[family](rng, n)
    # mild random gamma (exposure) like real camera pipelines
    rgb = rgb ** rng.uniform(0.8, 1.25)
    u8 = (rgb * 255.0 + 0.5).astype(np.uint8)
    if rng.rand() < noise_frac:
        r = rng.rand()
        if r < 0.4:          # signal-dependent sensor noise (mild ISO)
            u8 = _camera_degrade(u8, rng)
        elif r < 0.7:        # re-saved web photo (mild JPEG)
            u8 = _jpeg_roundtrip(u8, rng.randint(55, 92))
        else:                # legacy uniform dither
            k = int(rng.choice([1, 2, 4, 6]))
            u8 = np.clip(u8.astype(np.int16)
                         + rng.randint(-k, k + 1, u8.shape),
                         0, 255).astype(np.uint8)
    return u8


def numpy_probe() -> str:
    """sha256 of this host's numpy results for what the families lean on:
    float64 exp, sin, cos, power and log of a seeded array, and irfft2 of
    a seeded spectrum. numpy sends these to SIMD code chosen by the CPU
    and the build, so two hosts with one probe render the same tiles bit
    for bit; where the probes differ, a tile may differ by one grey level
    at some pixels."""
    r = np.random.RandomState(20261017)
    x = r.uniform(-30.0, 30.0, 4099)
    y = r.uniform(0.05, 3.0, 4099)
    spec = r.normal(size=(64, 33)) + 1j * r.normal(size=(64, 33))
    h = hashlib.sha256()
    for a in (np.exp(x), np.sin(x), np.cos(x), np.power(np.abs(x), y),
              np.log(np.abs(x) + 1e-3), np.fft.irfft2(spec, s=(64, 64))):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def generate_families(out_dir: str, tiles_per_family: int = 40,
                      n: int = 256, seed: int = 0,
                      families: List[str] | None = None) -> List[str]:
    """Write PNG tiles for each family into out_dir; returns paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for fi, fam in enumerate(families or list(FAMILIES)):
        for t in range(tiles_per_family):
            p = os.path.join(out_dir, f"synth_{fam}_{t:04d}.png")
            if not os.path.isfile(p):
                # per-TILE rng: extending an existing directory with a
                # larger tiles_per_family must not replay the family
                # stream from its start (the skip path above does not
                # advance a shared rng, which would duplicate tile 0)
                rng = np.random.RandomState(
                    (seed * 1000 + fi) * 100003 + t + 1)
                write_png(p, render_tile(fam, rng, n))
            paths.append(p)
    return paths
