"""What the training drivers share: the program's training step built from
the configuration and the seed's weights, the pool of input batches, the
first steps whose readings decide ``correct``, and the plain reference's
readings of the same steps.

What a configuration trains (its ``networks``) decides in one place,
:meth:`TrainDriver.networks`, which weights are drawn, which reference
steps the program is checked against and which model FLOPs a step counts.

A reading is what a comparison needs and nothing more: each step's loss,
the networks' outputs in the first step and the norm of each row of the
loss's gradient with respect to the first network's outputs (on the
program's side taken by forward and tensor hooks from the step's own call),
the norm of each leaf of the first gradient as the optimizer got it (Adam's
first moment after one update, over 1 - beta1), and the norm of each leaf's
change after the checked steps, all in float64.
"""

from __future__ import annotations

import copy
import functools
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from benchmark import inputs
from benchmark.reference import nets, train

CHECK_STEPS = 3
# BatchNorm's running statistics at their initial values.
BN_STATS = {"running_mean": 0, "running_var": 1, "num_batches_tracked": 0}


@dataclass(frozen=True)
class Networks:
    """What a configuration's step trains, as the harness draws, checks and
    counts it.

    ``spec``: (name, shape, kind) of every trained parameter, its name
    prefixed by its network's, in the order the weights are drawn
    (``inputs.draw_weights``). ``steps(weights, batches, noises,
    precision)``: the plain reference's checked steps from those weights
    (``reference.train.run_steps``' result). ``flops(batch, height,
    width)``: the model FLOPs of one step over ``batch`` rows, counted on
    the reference networks."""

    spec: List[Tuple[str, tuple, str]]
    steps: Callable[..., Dict]
    flops: Callable[[int, int, int], int]


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def row_norms(t: torch.Tensor) -> torch.Tensor:
    """The norm of each row (first axis) of ``t``, in float64 on the host."""
    return t.detach().double().reshape(t.shape[0], -1).norm(dim=1).cpu()


class TrainDriver:
    """Set-up of one rank: weights, inputs, the program's state and step.

    ``fault`` plants one of ``run.FAULTS`` under the program's step, for
    the tests and the calibration of the limits; a benchmark run has none:
    ``unchanged``, its state left as it was; ``half_batch``, the step run
    on the first half of the rows alone; ``half_loss``, the networks run on
    every row, the gradient taken as from the mean over the first half
    alone; ``no_exchange``, the ranks' exchange left out."""

    def __init__(self, cell, seed: int, device: torch.device, mesh, batch: int,
                 height: int, width: int, pool: int, fault: Optional[str] = None):
        self.seed, self.device, self.mesh = seed, device, mesh
        self.batch, self.height, self.width, self.pool_size = batch, height, width, pool
        self.world = mesh.world if mesh is not None else 1
        self.rank = mesh.rank if mesh is not None else 0
        self.fault = fault
        self.cell, self.config = cell, cell.config
        self.dtype = getattr(torch, self.config["compute_dtype"])
        self.optim = self.config["optimizer"]
        self.trained = self.networks()
        start = time.perf_counter()
        self.init_weights = inputs.draw_weights(self.trained.spec, seed, device)
        weights = time.perf_counter()
        self.pool = self._draw_pool(pool, rows=self._rows())
        drawn = time.perf_counter()
        self.models = self.build_models()
        for prefix, model in self.models.items():
            _load(model, self.init_weights, prefix)
            if fault == "half_loss":
                model.register_forward_hook(self._keep_half_the_rows)
        self.state, self.train_step = self.build_step(
            None if fault == "no_exchange" else mesh)
        self.setup_s = {"weights": weights - start, "inputs": drawn - weights,
                        "program": time.perf_counter() - drawn}
        self.next_batch = 0

    # --- what each driver defines -------------------------------------
    def networks(self) -> Networks:
        """What the step trains. The base case: DepthNet under the
        supervised depth loss (``networks``: ``depth``), and DepthNet with
        PoseNet under the VO loss (``depth_pose``). A driver of another
        network returns its own, from its reference module
        (``cells.reference``), and hands any other ``networks`` on to this
        one, which refuses it."""
        name = self.config["networks"]
        if name not in ("depth", "depth_pose"):
            raise SystemExit(f"configuration {self.config['name']!r}: no driver or reference "
                             f"defines its networks {name!r} (driver {self.config['driver']!r})")
        cfg = self.config["loss"]
        spec = [("depth." + n, s, k) for n, s, k in nets.depthnet_spec()]
        if name == "depth_pose":
            spec += [("pose." + n, s, k) for n, s, k in nets.posenet_spec()]

            def loss(params, batch, noise, precision):
                return train.vo_loss_and_grads(params, batch, noise, cfg, precision)
        else:
            def loss(params, batch, noise, precision):
                return train.depth_loss_and_grads(params, batch, cfg, precision)

        def steps(weights, batches, noises, precision):
            return train.run_steps(loss, weights, batches, noises, self.optim, precision)

        def flops(batch: int, height: int, width: int) -> int:
            # 2 per multiply-add of every convolution of the forward, times
            # 3 for the forward and the backward; VO runs PoseNet on the two
            # (source, target) pairs of each snippet.
            n = nets.forward_flops(nets.depthnet_spec(), nets.depthnet,
                                   (batch, height, width, 3))
            if name == "depth_pose":
                n += nets.forward_flops(nets.posenet_spec(), nets.posenet,
                                        (2 * batch, height, width, 6))
            return 3 * n

        return Networks(spec, steps, flops)

    def build_models(self) -> Dict[str, torch.nn.Module]:
        """The program's networks by parameter prefix, the network whose
        outputs the loss reads by row (``ddisp``) first. ``_load`` sets
        every parameter and BatchNorm's running statistics, and no other
        buffer: a network with other buffers builds them itself."""
        raise NotImplementedError

    def build_step(self, mesh):
        raise NotImplementedError

    def draw_entry(self, gen_batch, gen_noise, B: int) -> Dict:
        """One pool entry of ``B`` rows: ``{"batch": ..., "noise": ... or None}``."""
        raise NotImplementedError

    def call_step(self, entry: Dict) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @staticmethod
    def ordered_outputs(out) -> List[torch.Tensor]:
        """A network's output tensors in the reference's order: a lone
        tensor is one output, a dict's come by key, a tuple's in turn."""
        if isinstance(out, torch.Tensor):
            return [out]
        return [out[k] for k in sorted(out)] if isinstance(out, dict) else list(out)

    @classmethod
    def flat_outputs(cls, out) -> List[torch.Tensor]:
        """A network's outputs in the reference's order and shapes: a
        tuple's each flattened to rows, the others as they are."""
        tensors = cls.ordered_outputs(out)
        if isinstance(out, (tuple, list)):
            return [o.reshape(o.shape[0], -1) for o in tensors]
        return tensors

    def reference_rows(self, outputs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The reference's global outputs cut to this rank's rows (a network
        run over two pairs a row: this rank's rows of each half)."""
        rows, B = self._rows(), self.batch * self.world
        cut = []
        for o in outputs:
            if o.shape[0] == B:
                cut.append(o[rows])
            else:
                cut.append(torch.cat([o[rows], o[B + rows.start:B + rows.stop]]))
        return cut

    # --- inputs -----------------------------------------------------------
    def _rows(self) -> slice:
        return slice(self.rank * self.batch, (self.rank + 1) * self.batch)

    def _draw_pool(self, n: int, rows: slice) -> List[Dict]:
        """``n`` entries of the global batch, each cut to ``rows``. Every
        rank draws the same global entries from the same generators."""
        gb = inputs.generator(self.seed, inputs.BATCHES, self.device)
        gn = inputs.generator(self.seed, inputs.NOISE, self.device)
        pool = []
        for _ in range(n):
            entry = self.draw_entry(gb, gn, self.batch * self.world)
            pool.append({
                "batch": {k: v[rows].contiguous() for k, v in entry["batch"].items()},
                "noise": None if entry["noise"] is None
                else [x[rows].contiguous() for x in entry["noise"]],
            })
            del entry
        return pool

    def next_entry(self) -> Dict:
        """The pool's next entry, in turn."""
        entry = self.pool[self.next_batch % self.pool_size]
        self.next_batch += 1
        return entry

    @property
    def samples_per_step(self) -> int:
        return self.batch * self.world

    # --- the program's steps ----------------------------------------------
    def step(self, entry: Dict) -> Dict[str, torch.Tensor]:
        """One step of the program on ``entry``, with the planted fault."""
        if self.fault == "half_batch":
            half = slice(0, self.batch // 2)
            entry = {"batch": {k: v[half] for k, v in entry["batch"].items()},
                     "noise": None if entry["noise"] is None
                     else [x[half] for x in entry["noise"]]}
        if self.fault != "unchanged":
            return self.call_step(entry)
        params = {k: p.detach().clone() for k, p in self.named_params().items()}
        opt = copy.deepcopy(self.state.optimizer.state_dict())
        out = self.call_step(entry)
        with torch.no_grad():
            for k, p in self.named_params().items():
                p.copy_(params[k])
        self.state.optimizer.load_state_dict(opt)
        return out

    def _keep_half_the_rows(self, module, inputs, out) -> None:
        """The fault ``half_loss``, as a forward hook: the gradient reaching
        each output keeps the rows of the batch's first half, doubled, and
        drops the others, as a loss that is a mean over rows gives when it
        is taken over the first half alone."""
        rows = (torch.arange(self.batch, device=self.device) < self.batch // 2).double() * 2
        for t in self.ordered_outputs(out):
            if t.requires_grad:
                keep = rows.repeat(t.shape[0] // self.batch).to(t.dtype)
                t.register_hook(lambda g, k=keep: g * k.reshape(-1, *[1] * (g.dim() - 1)))

    def named_params(self) -> Dict[str, torch.nn.Parameter]:
        return {f"{prefix}{n}": p for prefix, m in self.models.items()
                for n, p in m.named_parameters()}

    def check_steps(self) -> Dict:
        """The first steps of the run, through the window's own call, on
        pool entries that all differ; returns the program's readings and
        frees the initial weights."""
        beta1 = self.optim["beta1"]
        step_losses, grads, outputs, ddisp = [], None, {}, []

        def keep_ddisp(i, g):
            # Under data parallelism a rank's loss is the mean over its own
            # rows: the global mean's gradient is 1/world of it.
            ddisp[i] = row_norms(g) / self.world

        def keep(name):
            def hook(module, inputs, out):
                if name in outputs:
                    return
                outputs[name] = [o.detach().float().cpu() for o in self.flat_outputs(out)]
                if name != first:
                    return
                for t in self.ordered_outputs(out):
                    ddisp.append(None)
                    if t.requires_grad:
                        t.register_hook(functools.partial(keep_ddisp, len(ddisp) - 1))
            return hook

        first = next(iter(self.models))
        hooks = [m.register_forward_hook(keep(prefix)) for prefix, m in self.models.items()]
        for i in range(CHECK_STEPS):
            out = self.step(self.next_entry())
            for h in hooks:
                h.remove()
            hooks = []
            step_losses.append(out["loss"].detach())
            if grads is None:
                grads = {}
                for k, p in self.named_params().items():
                    m = self.state.optimizer.state.get(p, {}).get("exp_avg")
                    grads[k] = torch.zeros_like(p) if m is None else m / (1 - beta1)
                grads = leaf_norms(grads)
        params = self.named_params()
        change = leaf_norms({k: p.detach() - self.init_weights[k] for k, p in params.items()})
        reading = {"losses": [float(x) for x in step_losses], "grad": grads,
                   "change": change, "ranks": self._rank_gap(params),
                   "outputs": [o for prefix in self.models for o in outputs[prefix]],
                   "ddisp": ddisp}
        del self.init_weights
        return reading

    def _rank_gap(self, params) -> Optional[float]:
        """Under a mesh, the largest difference of any parameter from rank
        0's; None in one process."""
        if self.mesh is None:
            return None
        flat = torch.cat([p.detach().reshape(-1) for p in params.values()])
        mine = flat.clone()
        dist.broadcast(flat, src=0)
        gap = (mine - flat).abs().max().reshape(1)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        return float(gap)

    def free(self) -> None:
        """Drops the program's state, step and inputs."""
        self.state = self.train_step = self.models = self.pool = None

    # --- the reference ------------------------------------------------------
    def reference_reading(self, precision=nets.FP32) -> Dict:
        """The plain reference's readings of the checked steps over the
        global batch, from the seed's weights and inputs, TF32 off."""
        entries = self._draw_pool(CHECK_STEPS, rows=slice(None))
        weights = inputs.draw_weights(self.trained.spec, self.seed, self.device)
        init = {k: v.clone() for k, v in weights.items()}
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            out = self.trained.steps(
                weights, [e["batch"] for e in entries],
                [e["noise"] for e in entries if e["noise"] is not None], precision)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return {"losses": out["losses"], "grad": leaf_norms(out["first_grad"]),
                "change": leaf_norms({k: v - init[k] for k, v in out["params"].items()}),
                "ranks": None,
                "outputs": [o.float().cpu() for o in self.reference_rows(out["first_outputs"])],
                "ddisp": [row_norms(d) for d in self.reference_rows(out["first_ddisp"])]}


def _load(model: torch.nn.Module, weights: Dict[str, torch.Tensor], prefix: str) -> None:
    """The seed's weights into ``model`` by name, and BatchNorm's running
    statistics at their initial values; every other buffer (a constant of
    the network, such as an input normalisation) stays as the model built
    it. The names must match exactly."""
    names = {n for n, _ in model.named_parameters()}
    want = {k[len(prefix):] for k in weights if k.startswith(prefix)}
    if names != want:
        raise RuntimeError(f"the program's {prefix[:-1]} parameters differ from the "
                           f"reference's: {sorted(names ^ want)[:6]}")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[prefix + n])
        for n, b in model.named_buffers():
            start = BN_STATS.get(n.rsplit(".", 1)[-1])
            if start is not None:
                b.fill_(start)
