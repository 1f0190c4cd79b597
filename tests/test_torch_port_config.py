"""The port's `.cf` parser, log-dir names and checkpoint choice against the
JAX package's, on the CPU.

- `load_ms_config` of the port's own `configs/ms/cr.cf` equals the JAX
  package's `load_ms_config` of its own, field by field (`compute_dtype`
  included, whose only ported value is 'float32');
- `parse_cf` (with `use` inheritance), `parse_overrides`, unknown keys;
- `find_log_dir` / `parse_log_dir` / `log_date_from_log_dir` give the JAX
  package's answers on the `models_zoo/` names (spaces, `r@...`
  components and postfixes included), each package resolving against its
  own config root;
- the RGB baseline configs (`cr_rgb.cf`, `cr_rgb_shared.cf`) load field
  for field as the JAX package's; q.C == 3 outside a baseline is refused;
- `weights.restore_params_only` picks the checkpoint `Restorer` picks.
"""
import dataclasses
import os

import pytest

from l3c_tpu import config as jcfg
from l3c_tpu.train.saver import Restorer
from l3c_tpu.utils import logdir as jlogdir
from l3c_torch import config as tcfg
from l3c_torch.cli.l3c import default_config_roots
from l3c_torch.models import weights
from l3c_torch.utils import logdir as tlogdir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(ROOT, "models_zoo")
J_CONFIGS = os.path.join(ROOT, "l3c_tpu", "configs")
T_CONFIGS = os.path.join(ROOT, "l3c_torch", "configs")


def _flat(cfg, prefix=""):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = v
    return out


def test_cr_cf_equals_jax_field_by_field():
    t = _flat(tcfg.load_ms_config(os.path.join(T_CONFIGS, "ms", "cr.cf")))
    j = _flat(jcfg.load_ms_config(os.path.join(J_CONFIGS, "ms", "cr.cf")))
    assert j["compute_dtype"] == "float32"
    assert t == j
    for k in t:
        assert type(t[k]) is type(j[k]), k
    # the dataclass defaults are cr.cf
    assert _flat(tcfg.MsConfig()) == t
    assert tcfg.MsConfig().padding_fac == jcfg.MsConfig().padding_fac == 8


def test_the_port_keeps_its_own_copy_of_the_config_files():
    for rel in ("ms/cr.cf", "ms/cr_rgb.cf", "ms/cr_rgb_shared.cf",
                "dl/oi_offline.cf", "dl/oi.cf", "dl/in32.cf", "dl/in64.cf"):
        assert (open(os.path.join(T_CONFIGS, rel)).read()
                == open(os.path.join(J_CONFIGS, rel)).read()), rel
    assert os.path.samefile(default_config_roots()[0], T_CONFIGS)


@pytest.mark.parametrize("name", ["oi.cf", "in32.cf", "in64.cf",
                                  "oi_offline.cf"])
def test_dl_configs_parse_to_jax_values(name):
    """Every data config the port ships loads field for field (types
    included) as the JAX package's own copy does; in32/in64 inherit oi.cf
    through `use`."""
    t = _flat(tcfg.load_dl_config(os.path.join(T_CONFIGS, "dl", name)))
    j = _flat(jcfg.load_dl_config(os.path.join(J_CONFIGS, "dl", name)))
    assert t == j
    for k in t:
        assert type(t[k]) is type(j[k]), k
    assert t["crop_size"] == {"in32.cf": 32, "in64.cf": 64}.get(name, 128)


@pytest.mark.parametrize("overrides", [
    [], ["num_scales=2", "q.C=4", "prob.K=2", "enc.num_blocks=1"],
    ["lr.initial=0.001", "q.levels_range=(-2, 2)", "after_q1x1=False"]])
def test_overrides_equal_jax(overrides):
    t = tcfg.load_ms_config(os.path.join(T_CONFIGS, "ms", "cr.cf"),
                            tcfg.parse_overrides(overrides))
    j = jcfg.load_ms_config(os.path.join(J_CONFIGS, "ms", "cr.cf"),
                            jcfg.parse_overrides(overrides))
    assert _flat(t) == _flat(j)
    assert tcfg.parse_overrides(overrides + ["flag"]) \
        == jcfg.parse_overrides(overrides + ["flag"])


def test_parse_cf_inheritance_and_errors(tmp_path):
    (tmp_path / "base.cf").write_text(
        "# comment\nnum_scales = 2\nCf = 8   # trailing\nq.C = 4\n"
        "lr.schedule = 'exp_0.5_e1'\n")
    (tmp_path / "child.cf").write_text("use base.cf\nCf = 16\nprob.K = 2\n")
    for mod in (tcfg, jcfg):
        assert mod.parse_cf(str(tmp_path / "child.cf")) == {
            "num_scales": 2, "Cf": 16, "q.C": 4, "prob.K": 2,
            "lr.schedule": "exp_0.5_e1"}
    cfg = tcfg.load_ms_config(str(tmp_path / "child.cf"))
    assert (cfg.num_scales, cfg.Cf, cfg.q.C, cfg.prob.K, cfg.lr_schedule) \
        == (2, 16, 4, 2, "exp_0.5_e1")
    (tmp_path / "bad.cf").write_text("use base.cf\nno_such_key = 1\n")
    with pytest.raises(ValueError, match="no_such_key"):
        tcfg.load_ms_config(str(tmp_path / "bad.cf"))
    (tmp_path / "line.cf").write_text("num_scales 2\n")
    with pytest.raises(ValueError, match="cannot parse"):
        tcfg.parse_cf(str(tmp_path / "line.cf"))


@pytest.mark.parametrize("name", ["cr_rgb.cf", "cr_rgb_shared.cf"])
def test_unported_configs_raise_with_their_roadmap_item(name):
    """The RGB baselines, once refused by name, now load as the JAX
    package loads them (every field equal; shared_across_scales is parsed
    and no network reads it); q.C == 3 is still refused outside a
    baseline."""
    j = jcfg.load_ms_config(os.path.join(J_CONFIGS, "ms", name))
    t = tcfg.load_ms_config(os.path.join(T_CONFIGS, "ms", name))
    assert j.rgb_bicubic_baseline and t.rgb_bicubic_baseline
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        assert (dataclasses.asdict(got) == dataclasses.asdict(want)
                if dataclasses.is_dataclass(got) else got == want), f.name
    assert (t.enc.cls, t.q.C, t.num_scales) == (
        "BicubicSubsampling", 3, 3 if name == "cr_rgb.cf" else 1)
    assert tcfg.MsConfig(shared_across_scales=True).shared_across_scales
    with pytest.raises(ValueError, match="q.C == 3"):
        tcfg.MsConfig(q=tcfg.QConfig(C=3))


def test_log_dirs_of_the_models_zoo_equal_jax():
    names = sorted(os.listdir(ZOO))
    assert any(" r@" in n for n in names) and len(names) >= 4
    for name in names:
        date = name.split(" ")[0]
        d = tlogdir.find_log_dir(ZOO, date)
        assert d == jlogdir.find_log_dir(ZOO, date) \
            == os.path.join(ZOO, name)
        assert tlogdir.log_date_from_log_dir(d) \
            == jlogdir.log_date_from_log_dir(d) == date
        t_date, t_paths = tlogdir.parse_log_dir(d, [T_CONFIGS])
        j_date, j_paths = jlogdir.parse_log_dir(d, [J_CONFIGS])
        assert t_date == j_date == date
        rel = lambda paths, root: [os.path.relpath(p, root) for p in paths]
        assert rel(t_paths, T_CONFIGS) == rel(j_paths, J_CONFIGS) \
            == [os.path.join("ms", "cr.cf"),
                os.path.join("dl", "oi_offline.cf")]


def test_log_dir_errors_equal_jax(tmp_path):
    for n in ("0101_0000 cr a", "0101_0001 cr b", "0202_0000 cr"):
        (tmp_path / n).mkdir()
    for mod in (tlogdir, jlogdir):
        assert mod.find_log_dir(str(tmp_path), "0202") \
            == str(tmp_path / "0202_0000 cr")
        with pytest.raises(ValueError, match="ambiguous"):
            mod.find_log_dir(str(tmp_path), "0101")
        with pytest.raises(FileNotFoundError):
            mod.find_log_dir(str(tmp_path), "0303")
        with pytest.raises(ValueError):
            mod.parse_log_dir(str(tmp_path / "nodate cr"), [T_CONFIGS])
        with pytest.raises(ValueError):
            mod.log_date_from_log_dir("/x/notadate cr")
        # a trailing separator and unknown components are skipped
        assert mod.parse_log_dir("/x/0101_0000 nope r@0101_0000 post/",
                                 [T_CONFIGS]) == ("0101_0000", [])


@pytest.mark.parametrize("itr", [-1, 0, 250, 600, 749, 750, 10 ** 6])
def test_checkpoint_choice_equals_restorer(tmp_path, monkeypatch, itr):
    """restore_params_only reads the file Restorer.get_ckpt_for_itr picks:
    -1 the newest, else the closest <= itr (the earliest when all are
    later); temporary checkpoints count, other files do not. (That the
    file's parameters then load is test_torch_port_tester.py's.)"""
    d = tmp_path / "ckpts"
    d.mkdir()
    for name in ("ckpt_0000000250.ckpt.tmp", "ckpt_0000000500.ckpt",
                 "ckpt_0000000750.ckpt.tmp", "notes.txt",
                 "ckpt_0000000750.ckpt.tmp.write"):
        (d / name).write_bytes(b"")
    assert weights.list_ckpts(str(tmp_path)) \
        == Restorer(str(tmp_path)).list_ckpts()
    monkeypatch.setattr(weights, "read_checkpoint",
                        lambda path: {"params": path})
    monkeypatch.setattr(weights, "params_from_jax", lambda tree: tree)
    assert weights.restore_params_only(str(tmp_path), itr) \
        == Restorer(str(tmp_path)).get_ckpt_for_itr(itr)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        weights.restore_params_only(str(tmp_path / "ckpts"), itr)
