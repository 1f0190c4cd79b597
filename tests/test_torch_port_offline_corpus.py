"""The port's offline corpus (data/offline_corpus.py, cli.prep_pipeline
--offline) against the JAX package's, on the CPU.

- every source of the manifest and the skybox (JPEG, 8- and 16-bit RGB
  and RGBA PNG) loads to the JAX package's load_image_uint8 pixels;
- build_corpus through both CLIs with both modules' `_SP` pointed at one
  root holding a few of the sources (a train and a val JPEG scene, an RGBA
  texture, the 16-bit val texture and the skybox's six faces) at reduced
  tile counts and size: the same file names in sources/, train/, val/ and
  val_full/, every tile's pixels equal, the same missing-source lines and
  summary, the same cache listings;
- with an empty root, both report every source missing and build empty
  splits.
Sources whose package is not installed are skipped.
"""
import os
import pickle
import sysconfig

import numpy as np
import pytest

from l3c_tpu.cli import prep_pipeline as jpipe
from l3c_tpu.data import images as jimages
from l3c_tpu.data import offline_corpus as joc
from l3c_torch.cli import prep_pipeline as tpipe
from l3c_torch.data import images as timages
from l3c_torch.data import offline_corpus as toc

SP = sysconfig.get_paths()["purelib"]
SOURCES = [rel for rel, _, _ in toc.MANIFEST] + [toc.SKYBOX]
SUBSET = ("pygame/docs/generated/_images/camera_background.jpg",
          "pygame/docs/generated/_images/camera_rgb.jpg",
          "gymnasium_robotics/envs/assets/adroit_hand/resources/textures/"
          "foil.png",
          "gymnasium_robotics/envs/assets/kitchen_franka/kitchen_assets/"
          "textures/wood1.png",
          toc.SKYBOX)


def test_manifest_equals_jax():
    assert toc.MANIFEST == joc.MANIFEST and toc.SKYBOX == joc.SKYBOX
    assert toc.SKYBOX_FACES == joc.SKYBOX_FACES and len(SOURCES) == 18


@pytest.mark.parametrize("rel", SOURCES, ids=os.path.basename)
def test_every_source_loads_as_jax(rel):
    p = os.path.join(SP, rel)
    if not os.path.isfile(p):
        pytest.skip(f"corpus source {rel} is not installed")
    np.testing.assert_array_equal(timages.load_image_uint8(p),
                                  jimages.load_image_uint8(p))


def _run_both(monkeypatch, capsys, root, tmp, args):
    """Both CLIs' --offline over `root`: their output roots and (stdout,
    stderr) with the output roots written as OUT."""
    monkeypatch.setattr(joc, "_SP", root)
    monkeypatch.setattr(toc, "_SP", root)
    outs, caps = [], []
    for name, main in (("t", tpipe.main), ("j", jpipe.main)):
        out = os.path.join(tmp, name)
        assert main(["--offline", out, *args]) == 0
        cap = capsys.readouterr()
        caps.append((cap.out.replace(out, "OUT"), cap.err))
        outs.append(out)
    assert caps[0] == caps[1]
    return outs, caps[0]


def _tree(out):
    return {sub: sorted(os.listdir(os.path.join(out, sub)))
            for sub in ("sources", "train", "val", "val_full")}


def test_build_corpus_equals_jax(tmp_path, monkeypatch, capsys):
    present = [rel for rel in SUBSET if os.path.isfile(os.path.join(SP,
                                                                    rel))]
    if len(present) < len(SUBSET):
        pytest.skip("a corpus source of the subset is not installed")
    root = tmp_path / "site"
    for rel in present:
        os.makedirs(root / os.path.dirname(rel), exist_ok=True)
        os.symlink(os.path.join(SP, rel), root / rel)
    (t_out, j_out), (out, err) = _run_both(
        monkeypatch, capsys, str(root), str(tmp_path),
        ["--tiles_scene", "2", "--tiles_texture", "1", "--tile", "64",
         "--noise_frac", "0.5"])
    assert err.count("(skipped)") == 13
    assert "offline corpus: 9 train tiles, 8 val tiles, 2 whole held-out " \
           "val images -> OUT" in out
    tree = _tree(t_out)
    assert tree == _tree(j_out) and len(tree["sources"]) == 10
    for sub, names in tree.items():
        for n in names:
            np.testing.assert_array_equal(
                timages.load_image_uint8(os.path.join(t_out, sub, n)),
                jimages.load_image_uint8(os.path.join(j_out, sub, n)))
    caches = [pickle.load(open(os.path.join(o, "cache.pkl"), "rb"))
              for o in (t_out, j_out)]
    rel = lambda c, o: {os.path.relpath(k[0], o): [os.path.relpath(p, o)
                                                   for p in v]
                        for k, v in c.items()}
    assert rel(caches[0], t_out) == rel(caches[1], j_out)


def test_empty_root_reports_every_source_missing(tmp_path, monkeypatch,
                                                 capsys):
    (root := tmp_path / "empty").mkdir()
    (t_out, _), (out, err) = _run_both(monkeypatch, capsys, str(root),
                                       str(tmp_path), [])
    assert err.splitlines() == [f"offline corpus: missing {rel} (skipped)"
                                for rel, _, _ in toc.MANIFEST]
    assert "offline corpus: 0 train tiles, 0 val tiles, 0 whole held-out " \
           "val images -> OUT" in out
    assert all(not names for names in _tree(t_out).values())
