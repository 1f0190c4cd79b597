"""The port's import boundary and its no-fallback rule.

l3c_torch, chip_smoke.py and the card scripts beside it (profile_k6.py,
train_fresh.py) must import nothing of JAX (jax, flax, optax)
and nothing of the JAX package (l3c_tpu) or its tools, and no Pillow,
scipy, scikit-learn or msgpack (the card machine does not have them: the
port reads images, resamples and prepares data itself). An `ast` scan,
not a sys.modules check: the environment may preload jax into every
process; it sees imports under `try:` and in functions too, and calls of
importlib.import_module / __import__ with a forbidden name.
"""
import ast
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "l3c_tpu", "tools", "PIL",
             "msgpack", "scipy", "sklearn")


def _port_files():
    out = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "profile_k6.py",
                                           "train_fresh.py")]
    for d, subdirs, names in os.walk(os.path.join(ROOT, "l3c_torch")):
        subdirs[:] = [s for s in subdirs if s != "_build"]  # build output
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_l3c_tpu():
    files = _port_files()
    rel = {os.path.relpath(p, ROOT) for p in files}
    # the scan reaches every package of the port, the serving entry
    # points included
    assert len(files) >= 30, files
    assert {"l3c_torch/" + m for m in (
        "config.py", "cli/l3c.py", "cli/test.py", "data/images.py",
        "eval/tester.py", "eval/timer.py", "utils/logdir.py",
        "utils/printer.py", "models/weights.py", "codec/bitcoding2.py",
        "ops/kernels/__init__.py", "cli/train.py", "train/trainer.py",
        "train/optim.py", "train/saver.py", "train/schedule.py",
        "utils/summarizer.py", "ops/coder.py", "codec/__init__.py",
        "codec/bitcoding.py", "convert/torch_import.py", "cli/convert.py",
        "tools/swa.py", "eval/classic.py", "cli/classic.py",
        "parallel/__init__.py", "parallel/mesh.py", "parallel/fanout.py",
        "parallel/spatial.py", "data/jpeg.py", "data/resample.py",
        "data/prep.py", "data/offline_corpus.py", "cli/prep_pipeline.py",
        "data/synth.py", "data/ndimage.py", "data/jpeg_encode.py",
        "data/webp.py", "data/webp_tables.py", "data/gif.py",
        "data/tiff.py", "data/rasters.py", "data/dds.py",
        "tools/anchor_sweep.py")} <= rel
    bad = {os.path.relpath(p, ROOT): sorted(set(_imported_roots(p))
                                             & set(FORBIDDEN))
           for p in files}
    assert not {k: v for k, v in bad.items() if v}
    # the image readers decode every format themselves: no binding to a
    # system library (libjpeg, libwebp) either
    assert not {k: v for k, v in {
        r: sorted(set(_imported_roots(os.path.join(ROOT, r)))
                  & {"ctypes", "cffi", "PIL", "cv2", "imageio"})
        for r in rel if r.startswith("l3c_torch/data/")}.items() if v}
    # the parallel paths use torch.distributed (allowed: it is torch's)
    tree = ast.parse(open(os.path.join(ROOT, "l3c_torch", "parallel",
                                       "mesh.py")).read())
    assert any(isinstance(n, ast.Import) and any(
        a.name == "torch.distributed" for a in n.names)
        for n in ast.walk(tree))


def test_the_scan_sees_every_way_of_importing(tmp_path):
    """Imports under try:, in functions and through importlib are seen."""
    p = tmp_path / "m.py"
    p.write_text("import os\ntry:\n    from PIL import Image\nexcept "
                 "ImportError:\n    pass\ndef f():\n    import scipy.ndimage"
                 "\n    return importlib.import_module('sklearn')\n")
    assert set(_imported_roots(str(p))) & set(FORBIDDEN) == {
        "PIL", "scipy", "sklearn"}


def test_default_device_raises_without_cuda():
    from l3c_torch import device
    if torch.cuda.is_available():
        assert device.default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        device.default_device()
    from l3c_torch.codec.bitcoding2 import TorchBitcoding
    from l3c_torch.config import (DecConfig, EncConfig, MsConfig,
                                  ProbConfig)
    from l3c_torch.models.network import MultiscaleNetwork
    cfg = MsConfig(Cf=8, enc=EncConfig(num_blocks=1),
                   dec=DecConfig(num_blocks=1), prob=ProbConfig(K=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBitcoding(cfg, MultiscaleNetwork(cfg))
    from l3c_torch.cli import train as train_cli
    from l3c_torch.cli.l3c import default_config_roots
    root = default_config_roots()[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main([os.path.join(root, "ms", "cr.cf"),
                        os.path.join(root, "dl", "oi_offline.cf"), "logs"])


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers never compute on the CPU: a CPU tensor is refused
    before any build; only the dispatching wrappers route CPU tensors to
    the plain versions."""
    from l3c_torch.ops import kernels
    x = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.rans_encode("uniform", x, 8, 8, 25)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.rans_decode("uniform", x.to(torch.int32), 8, 8, 25)
    f = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.mixture_cdf_q(f, f, f, torch.zeros(16), 16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.pack_int(torch.zeros((1, 30, 2, 2)), 5, 0, False, 0.08,
                         -1.04)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dmll_nll(torch.zeros((1, 30, 2, 2)), torch.zeros(
            (1, 2, 2, 5)), False, 0.04, -0.999, 0.999)
