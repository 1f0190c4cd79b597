"""l3c_torch's training path against the JAX package's, on the CPU: the
schedules, the straight-through quantizer, the mixture loss and its
gradients, the training forward, the initializer, the optimizers and one
and five train steps, from the same parameters and batches (made with
numpy from a seed; JAX parameters carried across by params_from_jax).

Tolerances, each with its reason:
- schedules: 1e-6 relative (JAX computes the lr in float32);
- quantizer: bn_q and syms bitwise; bn and d(sum w bn)/dx within 1e-5;
- nll and its gradients: test_torch_port_kernels.assert_nll_close's and
  assert_grad_close's bounds, each element's tight bound plus its
  float32_spread (the two libraries' float32 exp and log differ by an
  ulp here and there, and XLA may fuse the mean's products, which an
  ill-conditioned term magnifies);
- the network (different convolution algorithms, float32): Out.P within
  1e-5 of each tensor's largest magnitude, the loss within 1e-5 relative,
  the parameter gradients within 1e-4 of each tensor's largest magnitude.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import flax.serialization as fser
import pytest
import torch

from l3c_tpu import blueprint as jbp
from l3c_tpu.config import (DecConfig, DlConfig, EncConfig, MsConfig,
                            ProbConfig, QConfig, load_ms_config)
from l3c_tpu.models import dmll as jdmll
from l3c_tpu.models import grids as jgrids
from l3c_tpu.models import quantizer as jquant
from l3c_tpu.models.network import MultiscaleNetwork as JNet
from l3c_tpu.train import optim as joptim
from l3c_tpu.train import saver as jsaver
from l3c_tpu.train import schedule as jsched
from l3c_tpu.train.trainer import Trainer as JTrainer
from l3c_torch import blueprint as tbp
from l3c_torch import config as tcfg
from l3c_torch.models import dmll as tdmll
from l3c_torch.models import quantizer as tquant
from l3c_torch.models.network import MultiscaleNetwork as TNet
from l3c_torch.models.weights import params_from_jax, params_to_jax
from l3c_torch.train import optim as toptim
from l3c_torch.train import saver as tsaver
from l3c_torch.train import schedule as tsched
from l3c_torch.train.trainer import Trainer as TTrainer
from tests.test_torch_port_kernels import (assert_grad_close,
                                           assert_nll_close, dmll_inputs,
                                           float32_spread)

torch.set_num_threads(1)


def tiny_cfgs(**over):
    """tests/test_training.py's tiny model in both packages."""
    j = MsConfig(num_scales=2, Cf=8, enc=EncConfig(num_blocks=1),
                 dec=DecConfig(num_blocks=1), q=QConfig(C=2, L=25),
                 prob=ProbConfig(K=2), **over)
    t = tcfg.MsConfig(num_scales=2, Cf=8, enc=tcfg.EncConfig(num_blocks=1),
                      dec=tcfg.DecConfig(num_blocks=1),
                      q=tcfg.QConfig(C=2, L=25), prob=tcfg.ProbConfig(K=2),
                      **over)
    return j, t


def batches(n, B=2, crop=16, seed=0):
    """Smooth gradients plus noise, uint8 (test_training's recipe)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a = rng.randint(0, 255, size=(B, 1, 1, 3))
        gy = np.linspace(0, 1, crop)[None, :, None, None]
        gx = np.linspace(0, 1, crop)[None, None, :, None]
        img = (a * gy + (255 - a) * gx) / (gy + gx + 1e-9).clip(min=1)
        img = np.clip(img + rng.randn(B, crop, crop, 3) * 4, 0, 255)
        out.append(img.astype(np.uint8))
    return out


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, fser.to_state_dict(
        jax.device_get(tree)))


def assert_tree_close(got, want, rel, path=""):
    """Every leaf of `want` within rel of its largest magnitude."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], rel, f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, path
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, (
        path, float(np.abs(got - want).max()), scale)


# ------------------------------------------------------------- schedules

@pytest.mark.parametrize("spec,epoch_len", [
    ("none", None), ("exp_0.75_e5", 7), ("exp_0.5_i10", None),
    ("exp_0.5_i10_warm_30_0.75_i10", 1), ("exp_0.9_e2_warm_1.5_0.5_i4", 6),
    ("cos_0.1_0.01_i100", None), ("cos_0.1_0.01_e3", 9)])
def test_schedule_matches_jax(spec, epoch_len):
    j = jsched.from_spec(spec, 3e-4, epoch_len)
    t = tsched.from_spec(spec, 3e-4, epoch_len)
    steps = np.arange(0, 240)
    want = np.asarray(jax.jit(jax.vmap(j))(jnp.asarray(steps, jnp.int32)))
    got = np.asarray([t(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------- quantizer

def test_quantize_straight_through_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1.3, 1.3, (2, 5, 7, 5)).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)
    lv = jgrids.levels(-1.0, 1.0, 25)

    def j_fn(a):
        q = jquant.quantize(a, jnp.asarray(lv), 2.0)
        return jnp.sum(q.bn * w), q

    (_, q_j), dx_j = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    q_t = tquant.quantize(xt, torch.from_numpy(lv), 2.0)
    (q_t.bn * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(q_t.syms.numpy(), np.asarray(q_j.syms))
    np.testing.assert_array_equal(q_t.bn_q.numpy(), np.asarray(q_j.bn_q))
    np.testing.assert_allclose(q_t.bn.detach().numpy(), np.asarray(q_j.bn),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=0,
                               atol=1e-5 * float(np.abs(dx_j).max()))
    # forward hard up to the straight-through sum's rounding
    assert float((q_t.bn - q_t.bn_q).detach().abs().max()) < 1e-6


# ------------------------------------------------------------------- nll

@pytest.mark.parametrize("rgb", [True, False])
def test_nll_and_gradients_match_jax(rgb):
    """nll and d/dl, d/dx against jax.grad: both tails, log-scales below
    and at -7, and on the RGB scale the lambda path."""
    _nll_matches_jax(rgb, 10, 3 if rgb else 5)


# the sizes where K6 runs channel groups (q.C = 9, 16) or its generic
# variant (K = 12, 16)
@pytest.mark.parametrize("rgb,K,C", [(False, 10, 9), (False, 4, 16),
                                     (True, 12, 3), (False, 16, 5)])
def test_nll_and_gradients_match_jax_beyond_the_tile(rgb, K, C):
    _nll_matches_jax(rgb, K, C)


def _nll_matches_jax(rgb, K, C):
    spec_t = tdmll.DMLLSpec(True) if rgb else tdmll.DMLLSpec(False, -1.0,
                                                              1.0, 25)
    spec_j = jdmll.DMLLSpec(True) if rgb else jdmll.DMLLSpec(False, -1.0,
                                                              1.0, 25)
    x, l = dmll_inputs(rgb, K, 3 + rgb, H=11, W=13, C=C)
    g = np.random.RandomState(2).rand(*x.shape).astype(np.float32)

    def j_fn(l_, x_):
        n = jdmll.nll(spec_j, x_, l_)
        return jnp.sum(n * g), n

    (_, n_j), (dl_j, dx_j) = jax.jit(jax.value_and_grad(
        j_fn, argnums=(0, 1), has_aux=True))(jnp.asarray(l.numpy()),
                                             jnp.asarray(x.numpy()))
    xt, lt = x.clone().requires_grad_(True), l.clone().requires_grad_(True)
    n_t = tdmll.nll(spec_t, xt, lt)
    (n_t * torch.from_numpy(g)).sum().backward()
    spread = float32_spread(spec_t, x, l, torch.from_numpy(g))
    assert_nll_close(n_t.detach(), torch.from_numpy(np.array(n_j)),
                     spread[0])
    assert_grad_close("grad_l", lt.grad, torch.from_numpy(np.array(dl_j)),
                      spread[1])
    assert_grad_close("grad_x", xt.grad, torch.from_numpy(np.array(dx_j)),
                      spread[2])
    if rgb:      # the lambda terms reach channels 0 and 1
        assert float(np.abs(np.asarray(dx_j)[..., :2]).max()) > 0


# ------------------------------------------------------- network, steps

@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's tiny trainer: its initial state, the gradients
    and outputs of one train step on batch 0, and the states and metrics
    of five steps."""
    jc, _ = tiny_cfgs()
    dl = DlConfig(batchsize_train=2, batchsize_val=2, crop_size=16)
    net = JNet(jc)
    bs = batches(5)
    tr = JTrainer(jc, dl, net, iter(bs), epoch_len=10)
    state0 = np_tree(tr.state)
    x0 = jnp.asarray(bs[0], jnp.float32)

    def loss_fn(p):
        out = net.apply(p, x0, train=True)
        return jbp.compute_loss(jc, out).loss_pc, out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        tr.state["params"])
    states, metrics = [], []
    for b in bs:
        tr.state, m = tr._step(tr.state, jnp.asarray(b))
        states.append(np_tree(tr.state))
        metrics.append(jax.device_get(m))
    return dict(state0=state0, loss=float(loss), out=jax.device_get(out),
                grads=np_tree(grads), states=states, metrics=metrics,
                batches=bs)


def port_trainer(state, **over):
    _, tc = tiny_cfgs(**over)
    dl = tcfg.DlConfig(batchsize_train=2, batchsize_val=2, crop_size=16)
    tr = TTrainer(tc, dl, TNet(tc), [], epoch_len=10, device="cpu")
    tr.load_state_tree(state)
    return tr


def test_train_forward_matches_jax(jax_run):
    """MultiscaleNetwork.forward(train=True): S and bn (straight-through)
    as JAX's, P close, and the training loss."""
    tr = port_trainer(jax_run["state0"])
    with torch.no_grad():
        out = tr.net(torch.from_numpy(jax_run["batches"][0]).float(),
                     train=True)
        loss = tbp.compute_loss(tr.cfg, out)
    jo = jax_run["out"]
    for i in range(3):
        np.testing.assert_array_equal(out.S[i].numpy(), np.asarray(jo.S[i]))
        np.testing.assert_allclose(out.bn[i].numpy(), np.asarray(jo.bn[i]),
                                   rtol=0, atol=1e-6)
    for i in range(2):
        p_j = np.asarray(jo.P[i])
        np.testing.assert_allclose(out.P[i].numpy(), p_j, rtol=0,
                                   atol=1e-5 * np.abs(p_j).max())
    assert float(loss.loss_pc) == pytest.approx(jax_run["loss"], rel=1e-5)


def test_one_train_step_matches_jax(jax_run):
    """Loss, every parameter's gradient, grad_norm, lr, nu and the updated
    parameters against JAX's make_train_step. RMSprop's first update is
    ~lr * 10 * sign(g) per weight, so where |g| is near rounding the two
    packages may move a weight opposite ways: updates are compared where
    |g| > 1e-3 of its tensor's largest, and bounded by 2 lr 10 elsewhere."""
    tr = port_trainer(jax_run["state0"])
    m = tr.train_step(jax_run["batches"][0])
    mj = jax_run["metrics"][0]
    assert float(m["loss_bpsp"]) == pytest.approx(float(mj["loss_bpsp"]),
                                                  rel=1e-5)
    assert float(m["bpsp_total"]) == pytest.approx(float(mj["bpsp_total"]),
                                                   rel=1e-5)
    np.testing.assert_allclose(m["scale_bpsps"].numpy(),
                               np.asarray(mj["scale_bpsps"]), rtol=1e-5)
    assert m["lr"] == pytest.approx(float(mj["lr"]), rel=1e-6)
    grads = params_to_jax({n: p.grad for n, p in tr.named.items()})
    assert_tree_close(grads, jax_run["grads"], 1e-4)
    assert float(m["grad_norm"]) == pytest.approx(float(mj["grad_norm"]),
                                                  rel=1e-4)
    got, want = tr.state_tree(), jax_run["states"][0]
    assert int(got["step"]) == int(want["step"]) == 1
    assert_tree_close(got["opt_state"], want["opt_state"], 2e-4)
    lr = float(mj["lr"])
    p0 = jax_run["state0"]["params"]
    flat = lambda t: jax.tree_util.tree_leaves(t)
    n_cmp = 0
    for a, b, a0, g in zip(flat(got["params"]), flat(want["params"]),
                           flat(p0), flat(jax_run["grads"])):
        big = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose((a - a0)[big], (b - a0)[big], rtol=1e-3,
                                   atol=1e-3 * lr)
        assert np.abs(a - b).max() <= 2 * lr * 10 * (1 + 1e-3)
        n_cmp += int(big.sum())
    assert n_cmp > 0.9 * sum(x.size for x in flat(p0))


def test_five_train_steps_match_jax(jax_run):
    """Five steps' losses from the same start and batches, within 1e-4
    relative (the near-zero gradients' updates above may differ in sign)."""
    tr = port_trainer(jax_run["state0"])
    got = [float(tr.train_step(b)["loss_bpsp"]) for b in jax_run["batches"]]
    want = [float(m["loss_bpsp"]) for m in jax_run["metrics"]]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert tr.step == 5 and tr.count == 5


def test_init_draws_the_jax_distributions():
    """init_weights: every conv kernel U(+-1/sqrt(fan_in)) as flax's
    variance_scaling(1/3, fan_in, uniform), biases zero, as JAX's net.init
    at the same shapes: the same bound, a sample max near it and a
    standard deviation of bound / sqrt(3) within 10 % in both."""
    jc, tc = tiny_cfgs()
    jp = np_tree(jax.jit(lambda r, x: JNet(jc).init(r, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    net = TNet(tc)
    net.init_weights(torch.Generator().manual_seed(0))
    tp = params_to_jax(net.state_dict())
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    assert len(flat_j) == len(flat_t)
    for path, wj in flat_j:
        wt = flat_t[path]
        assert wt.shape == wj.shape
        if path[-1].key == "bias":
            assert not wj.any() and not wt.any()
            continue
        bound = 1.0 / np.sqrt(np.prod(wj.shape[:3]))
        for w in (wj, wt):
            assert np.abs(w).max() <= bound
            if w.size >= 500:
                assert np.abs(w).max() > 0.9 * bound
                assert abs(w.std() / (bound / np.sqrt(3)) - 1) < 0.1
    # two generators with the same seed give the same network
    again = TNet(tc)
    again.init_weights(torch.Generator().manual_seed(0))
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("optim,wd", [("Adam", 1e-3), ("SGD", 1e-3),
                                      ("RMSprop", 1e-3), ("Adam", 0.0)])
def test_optimizers_match_make_optimizer(optim, wd):
    """Two updates of the torch optimizer at the schedule's lr against
    make_optimizer's optax chain on the same parameters and gradients:
    parameters within 1e-5 of each tensor's largest magnitude plus
    lr-relative slack, and the state tree has optax's structure and
    values (derived from make_optimizer(cfg).init, not written by hand),
    and loads back."""
    jc, tc = tiny_cfgs(optim=optim, weight_decay=wd,
                       lr_schedule="exp_0.5_i1", lr_initial=1e-2)
    params = np_tree(jax.jit(lambda r, x: JNet(jc).init(r, x))(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3))))
    rng = np.random.RandomState(0)
    grads = [jax.tree_util.tree_map(
        lambda p: rng.randn(*p.shape).astype(np.float32), params)
        for _ in range(2)]
    opt = joptim.make_optimizer(jc, epoch_len=10)
    st = opt.init(params)
    p_j = params
    for g in grads:
        upd, st = opt.update(g, st, p_j)
        p_j = jax.tree_util.tree_map(lambda a, b: a + b, p_j, upd)
    p_j, st_j = np_tree(p_j), np_tree(st)

    net = TNet(tc)
    net.load_state_dict(params_from_jax(params))
    named = dict(net.named_parameters())
    topt = toptim.make_optimizer(tc, named.values())
    lr_fn = tsched.from_spec(tc.lr_schedule, tc.lr_initial, 10)
    for count, g in enumerate(grads):
        for n, t in params_from_jax(g).items():
            named[n].grad = t
        toptim.set_lr(topt, lr_fn(count))
        topt.step()
    assert_tree_close(params_to_jax(net.state_dict()), p_j, 1e-5)
    tree = toptim.state_tree(tc, topt, named, 2)
    assert_tree_close(tree, st_j, 1e-5)
    # and back: a fresh optimizer loaded from the tree gives it again
    topt2 = toptim.make_optimizer(tc, named.values())
    assert toptim.load_state_tree(tc, topt2, named, st_j) == 2
    assert_tree_close(toptim.state_tree(tc, topt2, named, 2), st_j, 0)


def test_bfloat16_and_heavy_summaries_raise():
    """compute_dtype = 'bfloat16' is taken (the conv stacks compute in
    bf16: test_torch_port_bf16.py), a dtype neither package computes in
    raises; the heavy summaries, once refused, now run (their tags against
    JAX's: test_torch_port_heavy.py): without a summary writer a heavy
    step writes nothing, and with one in bfloat16 it writes them."""
    assert tcfg.MsConfig(compute_dtype="bfloat16").compute_dtype == \
        "bfloat16"
    with pytest.raises(ValueError, match="float16"):
        tcfg.MsConfig(compute_dtype="float16")
    _, tc = tiny_cfgs()
    dl = tcfg.DlConfig(batchsize_train=2, crop_size=16)
    t = TTrainer(tc, dl, TNet(tc), iter(batches(1)), epoch_len=10,
                 device="cpu")
    m = t.train(1, heavy_every=1)
    assert np.isfinite(float(m["loss_bpsp"])) and not t._hist_buffers
    from tests.test_utils import FakeWriter
    w = FakeWriter()
    _, tb = tiny_cfgs(compute_dtype="bfloat16")
    t = TTrainer(tb, dl, TNet(tb), iter(batches(1)), epoch_len=10,
                 device="cpu", summary_writer=w)
    t.train(1, log_every=0, heavy_every=1)
    assert "train_heavy/bn/1/c0" in w.images
    assert "train/histo/enc_1_after_1x1" in w.histos


# --------------------------------------------------------- r5b, resumed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5B = os.path.join(ROOT, "models_zoo",
                   "0820_0345 cr oi_offline r@0819_0307 r5b")


def test_r5b_resumed_steps_match_jax():
    """r5b restored strictly in both packages at full cr.cf width, then
    three RMSprop steps at cr.cf's lr 1e-4 held constant
    (lr.schedule=none, as chip_smoke.py's resumed run) on the same seeded
    2 x 64^2 batches. Held: each step's loss within 1e-5 relative, the
    step and update count equal, and RMSprop's nu after each step, every
    leaf, within (1e-5, 1e-4, 1e-2) of its largest magnitude. nu gains
    1e-2 g^2 a step, and the two packages' float32 gradients part as the
    steps overshoot (the gradient norm goes 15.7 -> 47.3 -> 94.4 in both):
    on this CPU the largest departures were 7.9e-7, 1.1e-5 and 2.7e-3.
    The overshoot is JAX's too, so the port is not its cause; the same
    steps at r5b's final lr, 5e-6, stay within 5 % of the first loss."""
    over = {"lr.schedule": "none"}
    jc = load_ms_config(os.path.join(ROOT, "l3c_tpu", "configs", "ms",
                                     "cr.cf"), over)
    tc = tcfg.load_ms_config(os.path.join(ROOT, "l3c_torch", "configs",
                                          "ms", "cr.cf"), over)
    bs = batches(3, B=2, crop=64, seed=5)
    jt = JTrainer(jc, DlConfig(batchsize_train=2, crop_size=64), JNet(jc),
                  iter(bs), epoch_len=10)
    assert jt.restore(jsaver.Restorer(R5B)) == 246250

    def port(cfg):
        tr = TTrainer(cfg, tcfg.DlConfig(batchsize_train=2, crop_size=64),
                      TNet(cfg), [], epoch_len=10, device="cpu")
        assert tr.restore(tsaver.Restorer(R5B)) == 246250
        return tr

    tt = port(tc)
    got, want = [], []
    for b, rel in zip(bs, (1e-5, 1e-4, 1e-2)):
        jt.state, m = jt._step(jt.state, jnp.asarray(b))
        want.append(float(m["loss_bpsp"]))
        got.append(float(tt.train_step(b)["loss_bpsp"]))
        js, ts = np_tree(jt.state), tt.state_tree()
        assert int(ts["step"]) == int(js["step"])
        assert int(ts["opt_state"]["1"]["count"]) == int(
            js["opt_state"]["1"]["count"])
        assert_tree_close(ts["opt_state"]["0"]["nu"],
                          js["opt_state"]["0"]["nu"], rel)
    assert int(ts["step"]) == 246253
    low = port(tcfg.load_ms_config(os.path.join(
        ROOT, "l3c_torch", "configs", "ms", "cr.cf"),
        dict(over, **{"lr.initial": 5e-6})))
    slow = [float(low.train_step(b)["loss_bpsp"]) for b in bs]
    print(f"r5b resumed, 3 steps: lr 1e-4 port {got} JAX {want}; "
          f"lr 5e-6 port {slow}")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[2] > 1.2 * got[0] and want[2] > 1.2 * want[0]
    assert max(abs(v / slow[0] - 1) for v in slow) < 0.05
