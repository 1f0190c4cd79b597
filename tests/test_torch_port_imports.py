"""The port's import boundary and its no-fallback rule.

l3c_torch and chip_smoke.py must import nothing of JAX (jax, flax, optax)
and nothing of the JAX package (l3c_tpu) or its tools. An `ast` scan, not
a sys.modules check: the environment may preload jax into every process.
"""
import ast
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "l3c_tpu", "tools")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
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


def test_port_imports_no_jax_and_nothing_of_l3c_tpu():
    files = _port_files()
    assert len(files) >= 15, files
    bad = {os.path.relpath(p, ROOT): sorted(set(_imported_roots(p))
                                             & set(FORBIDDEN))
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


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


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers never compute on the CPU: a CPU tensor is refused
    before any build; only the dispatching wrappers route CPU tensors to
    the plain versions."""
    from l3c_torch.ops import kernels
    x = torch.zeros((4, 8), dtype=torch.int32)
    m = torch.ones((4, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.rans_encode(x, x, m)
    f = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.mixture_cdf_q(f, f, f, torch.zeros(16), 16)
