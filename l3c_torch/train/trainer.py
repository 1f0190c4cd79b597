"""Training runtime: the train and eval steps, the loop, validation and
checkpoints.

Port of `l3c_tpu/train/trainer.py`. One train step is the forward with
the straight-through bottlenecks, the loss (blueprint.compute_loss, whose
mixture NLL runs through K6 on the card, forward and backward), the
backward, the optimizer update at the schedule's lr, and the metrics
(loss_bpsp, bpsp_total, scale_bpsps, grad_norm, lr). The loop is
epochless: the schedule is a function of the step, so a restored run
needs no replay. Validation runs over fixed batches; checkpoints follow
the keep policy of train/saver.py, and a run whose length is no multiple
of keep_tmp_itr saves its last state too. Every `heavy_every` steps the
heavy summaries go to the summary writer: the bottleneck images and symbol
histograms, the observed-vs-predicted symbol distribution figures per scale
and the encoders' activation histograms, each computed on the device with
only counts and distributions crossing to the host.

Data parallelism (`world`): this process is one rank of a process group
(parallel/mesh.py). Every rank draws the same global batch, trains on its
rows (`shard_batch`) through the network under DDP (made at the first
step, so a restore on every rank comes before it), and logs the metrics
averaged over the ranks. Checkpoints keep the bare network's names, the
single-process format. Rank 0 alone saves, validates and writes summaries;
the other ranks wait at a barrier.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import blueprint
from ..config import DlConfig, MsConfig
from ..device import DeviceLike, resolve
from ..models import dmll, layers
from ..models.network import MultiscaleNetwork
from ..models.weights import params_from_jax, params_to_jax
from ..parallel.mesh import data_parallel, shard_batch
from ..utils.summarizer import Summarizer, add_scale_summaries, ps_figure
from . import optim as optim_mod
from . import schedule as schedule_mod
from .saver import Saver

# The encoders' activation histogram: fixed buckets over the 1x1 conv's
# output before the quantizer (the levels lie in [-1, 1]; +-4 catches
# outliers), counted on the device; the last HIST_BUFFER heavy steps' counts
# are summed into one histogram.
HIST_LO, HIST_HI, HIST_BINS, HIST_BUFFER = -4.0, 4.0, 80, 10


def make_enc_hist(net: MultiscaleNetwork):
    """fn(batch (B,H,W,3) on the device) -> {tag: (HIST_BINS,) counts} of
    every encoder's pre-quantizer activations, scales numbered from 1 (0 is
    the image); the bicubic encoders have none."""
    @torch.no_grad()
    def enc_hist(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        eos = net.enc_forward(layers.sub_rgb_mean(batch.to(torch.float32)))
        out = {}
        for i, eo in enumerate(eos):
            if eo.raw is None:
                continue
            idx = torch.clamp(((eo.raw.reshape(-1) - HIST_LO)
                               / (HIST_HI - HIST_LO) * HIST_BINS).to(
                                   torch.int32), 0, HIST_BINS - 1)
            out[f"histo/enc_{i + 1}_after_1x1"] = torch.bincount(
                idx, minlength=HIST_BINS)
        return out
    return enc_hist


def make_ps_stats(cfg: MsConfig, net: MultiscaleNetwork):
    """fn(img (N,H,W,3) on the device) -> {scale: (p_x, p_y)}: the
    observed symbol counts (L,) of each scale's target and the mean
    predicted distribution (dmll.mean_symbol_probs), both on the device."""
    @torch.no_grad()
    def ps_stats(img: torch.Tensor):
        out = net(img.to(torch.float32), train=False)
        spec0, spec_n = blueprint.rgb_spec(cfg), blueprint.bn_spec(cfg)
        stats = {}
        for i in range(len(out.P)):
            spec = spec0 if i == 0 else spec_n
            target = (out.S[i].to(torch.float32)
                      if i == 0 or cfg.rgb_bicubic_baseline else out.bn[i])
            p_x = torch.bincount(out.S[i].reshape(-1),
                                 minlength=spec.L)[:spec.L]
            stats[i] = (p_x, dmll.mean_symbol_probs(spec, target, out.P[i]))
        return stats
    return ps_stats


class Values:
    """Console metric line."""

    @staticmethod
    def format(step: int, metrics: Dict, img_per_s: float) -> str:
        s = (f"{step:8d} loss={float(metrics['loss_bpsp']):.4f} "
             f"bpsp={float(metrics['bpsp_total']):.4f} ")
        s += "scales=[" + " ".join(
            f"{float(b):.3f}" for b in metrics["scale_bpsps"].tolist()
        ) + "] "
        s += (f"gnorm={float(metrics['grad_norm']):.2f} "
              f"lr={float(metrics['lr']):.2e} {img_per_s:.1f} img/s")
        return s


def grad_norm(params: Iterable[torch.nn.Parameter]) -> torch.Tensor:
    """sqrt of the sum of all gradients' squares (optax.global_norm)."""
    norms = [torch.linalg.vector_norm(p.grad) for p in params
             if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(norms))


class Trainer:
    def __init__(self, cfg: MsConfig, dl_cfg: DlConfig,
                 net: MultiscaleNetwork,
                 train_batches: Iterable[np.ndarray],
                 val_batches: Optional[list] = None,
                 out_dir: Optional[str] = None,
                 epoch_len: Optional[int] = None, seed: int = 0,
                 summary_writer=None, device: DeviceLike = None,
                 world: Optional[int] = None):
        """world: None trains in this process alone; else the size of
        the initialized default process group this process is a rank of,
        trained data-parallel. Every rank then holds the same saver
        schedule (rank 0 alone writes) and the same loop arguments."""
        if world is not None and (not dist.is_initialized()
                                  or dist.get_world_size() != world):
            raise ValueError(f"world={world} needs an initialized process "
                             "group of that size")
        self.world = world
        self.rank = dist.get_rank() if world is not None else 0
        self._dp = None    # the DDP wrapper, made at the first step
        self.cfg, self.dl_cfg = cfg, dl_cfg
        self.device = resolve(device)
        net.init_weights(torch.Generator().manual_seed(seed))
        self.net = net.to(self.device)
        self.train_batches = train_batches
        self.val_batches = val_batches or []
        self.epoch_len = epoch_len
        self.summary_writer = summary_writer
        self.lr_fn = schedule_mod.from_spec(cfg.lr_schedule, cfg.lr_initial,
                                            epoch_len)
        self.named = dict(self.net.named_parameters())
        self.optimizer = optim_mod.make_optimizer(cfg, self.named.values())
        self.count = 0   # optimizer updates: the schedule's step
        self.step = 0
        self.saver = Saver(out_dir) if out_dir else None
        self.start_itr = 0
        self._enc_hist = make_enc_hist(self.net)
        self._ps_stats = make_ps_stats(cfg, self.net)
        self._hist_buffers: Dict[str, list] = {}   # tag -> recent counts

    # ------------------------------------------------------------ state

    def state_tree(self) -> Dict[str, Any]:
        """{'params', 'opt_state', 'step'} as the JAX package's train state
        (numpy leaves): what a checkpoint holds."""
        return {"params": params_to_jax(self.net.state_dict()),
                "opt_state": optim_mod.state_tree(
                    self.cfg, self.optimizer, self.named, self.count),
                "step": np.asarray(self.step, np.int32)}

    def load_state_tree(self, state: Dict[str, Any]) -> None:
        self.net.load_state_dict(params_from_jax(state["params"]),
                                 strict=True)
        self.count = optim_mod.load_state_tree(
            self.cfg, self.optimizer, self.named, state["opt_state"])
        self.step = int(np.asarray(state["step"]))

    def restore(self, restorer, itr: int = -1, restart: bool = False,
                strict: bool = True) -> int:
        """Load a checkpoint of `restorer`; with `restart` keep only its
        params (fresh optimizer state, step 0)."""
        template = self.state_tree()
        got_itr, state = restorer.restore(template, itr, strict=strict)
        if restart:
            state["opt_state"] = template["opt_state"]
            state["step"] = np.zeros((), np.int32)
            got_itr = 0
        self.load_state_tree(state)
        self.start_itr = int(got_itr)
        return got_itr

    # ------------------------------------------------------------ steps

    def _place(self, batch: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type == "cuda":
            # pinned: the copy does not wait for the card to go idle
            x = x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device).float()

    def train_step(self, batch: np.ndarray) -> Dict[str, Any]:
        """One update on a (B, H, W, 3) uint8 batch (data-parallel: the
        global batch, of which this rank trains its rows); metrics stay on
        the device (reading them waits for it) and are this rank's."""
        net = self.net
        if self.world is not None:
            batch = shard_batch(batch, self.rank, self.world)
            if self._dp is None:
                self._dp = data_parallel(self.net, self.device)
            net = self._dp
        x = self._place(batch)
        out = net(x, train=True)
        loss = blueprint.compute_loss(self.cfg, out)
        self.optimizer.zero_grad(set_to_none=True)
        loss.loss_pc.backward()
        gnorm = grad_norm(self.named.values())
        optim_mod.set_lr(self.optimizer, self.lr_fn(self.count))
        self.optimizer.step()
        metrics = {
            "loss_bpsp": loss.loss_pc.detach(),
            "bpsp_total": blueprint.total_bpsp(loss).detach(),
            # the uniform tail is a Python float: filled on the device, no
            # copy that would wait for it
            "scale_bpsps": torch.stack([
                b.detach() if torch.is_tensor(b) else
                torch.full((), b, device=self.device)
                for b in loss.nonrecursive_bpsps]),
            "grad_norm": gnorm.detach(),
            "lr": self.lr_fn(self.step),
        }
        self.count += 1
        self.step += 1
        return metrics

    def global_metrics(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """metrics with loss_bpsp, bpsp_total and scale_bpsps averaged
        over the ranks: each rank's are the mean over its rows, so with
        equal shards the average is the global batch's, as JAX's.
        grad_norm already reads the averaged gradients. A collective:
        every rank calls it."""
        if self.world is None:
            return metrics
        v = torch.cat([metrics["loss_bpsp"].reshape(1),
                       metrics["bpsp_total"].reshape(1),
                       metrics["scale_bpsps"]])
        dist.all_reduce(v)
        v = v / self.world
        return dict(metrics, loss_bpsp=v[0], bpsp_total=v[1],
                    scale_bpsps=v[2:])

    def _barrier(self) -> None:
        if self.world is not None:
            dist.barrier()

    @torch.no_grad()
    def eval_bpsp(self, batch: np.ndarray) -> float:
        out = self.net(self._place(batch), train=False)
        return float(blueprint.total_bpsp(
            blueprint.compute_loss(self.cfg, out)))

    def validation_loop(self) -> float:
        return float(np.mean([self.eval_bpsp(b) for b in self.val_batches]))

    def debug_step(self) -> Dict[str, Any]:
        """One train step + one val pass (train.py --debug)."""
        metrics = self.train_step(next(iter(self.train_batches)))
        if self.val_batches:
            metrics["val_bpsp"] = self.validation_loop()
        return metrics

    # ------------------------------------------------------------- loop

    def train(self, num_itr: int, log_every: int = 100,
              val_every: int = 500, heavy_every: int = 0,
              log_fn=print) -> Dict[str, Any]:
        it = iter(self.train_batches)
        t0 = time.time()
        imgs = 0
        metrics: Dict[str, Any] = {}
        main = self.rank == 0
        for i in range(self.start_itr, self.start_itr + num_itr):
            batch = next(it)
            metrics = self.train_step(batch)
            imgs += batch.shape[0]
            if log_every and (i + 1) % log_every == 0:
                shown = self.global_metrics(metrics)
                float(shown["loss_bpsp"])     # waits for the step
                dt = time.time() - t0
                if main:
                    log_fn(Values.format(i + 1, shown,
                                         imgs / max(dt, 1e-9)))
                    self._write_summaries("train", shown, i + 1)
                t0, imgs = time.time(), 0
            heavy = heavy_every and (i + 1) % heavy_every == 0
            val = val_every and (i + 1) % val_every == 0 and self.val_batches
            save = self.saver is not None and self.saver.save_due(i + 1)
            if main and heavy and self.summary_writer is not None:
                self._write_heavy_summaries(batch, i + 1)
            if main and val:
                val_bpsp = self.validation_loop()
                log_fn(f"{i + 1:8d} VAL bpsp={val_bpsp:.4f}")
                if self.summary_writer is not None:
                    self.summary_writer.add_scalar("val/bpsp", val_bpsp,
                                                   i + 1)
            if main and save:
                self.saver.save(self.state_tree(), i + 1)
            if heavy or val or save:
                self._barrier()
        # the state the run ended with is saved even when the interval
        # saver would drop it (short runs stay restorable)
        end = self.start_itr + num_itr
        if self.saver is not None and num_itr and not self.saver.save_due(end):
            if main:
                self.saver.save(self.state_tree(), end)
            self._barrier()
        return self.global_metrics(metrics) if metrics else metrics

    def _write_heavy_summaries(self, batch: np.ndarray, step: int):
        """The heavy summaries of `step`, under train_heavy/ and train/:
        on the first validation image (the training batch's first without
        one, so the images stay comparable across steps) the bottleneck
        images and symbol histograms per scale and the p_x / p_y figure per
        scale; on the training batch the encoders' activation histograms,
        summed over the last HIST_BUFFER heavy steps."""
        img = self._place(self.val_batches[0][:1] if self.val_batches
                          else batch[:1])
        s = Summarizer(self.summary_writer)
        s.enable("train_heavy", step)
        with torch.no_grad():
            out = self.net(img, train=False)
        # symbols of the scales above 0: bottleneck levels, or pixels
        add_scale_summaries(s, out, blueprint.bn_spec(self.cfg).L)
        for scale, (p_x, p_y) in self._ps_stats(img).items():
            s.figure(f"histo_out/{scale}", ps_figure(p_x.cpu().numpy(),
                                                     p_y.cpu().numpy()))
        edges = np.linspace(HIST_LO, HIST_HI, HIST_BINS + 1)
        for tag, c in self._enc_hist(self._place(batch)).items():
            buf = self._hist_buffers.setdefault(tag, [])
            buf.append(c.cpu().numpy())
            del buf[:-HIST_BUFFER]
            if hasattr(self.summary_writer, "add_histogram_counts"):
                self.summary_writer.add_histogram_counts(
                    f"train/{tag}", np.sum(buf, axis=0), edges, step)

    def _write_summaries(self, prefix: str, metrics: Dict, step: int):
        sw = self.summary_writer
        if sw is None:
            return
        sw.add_scalar(f"{prefix}/loss_bpsp", float(metrics["loss_bpsp"]),
                      step)
        sw.add_scalar(f"{prefix}/bpsp", float(metrics["bpsp_total"]), step)
        for i, b in enumerate(metrics["scale_bpsps"].tolist()):
            sw.add_scalar(f"{prefix}/costs/scale_{i}_bpsp", float(b), step)
        sw.add_scalar(f"{prefix}/grad_norm", float(metrics["grad_norm"]),
                      step)
        sw.add_scalar(f"{prefix}/lr", float(metrics["lr"]), step)
