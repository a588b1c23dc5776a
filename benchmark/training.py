"""What the two training drivers share: the program's training step built
from the configuration and the seed's weights, the pool of input batches,
the first steps whose readings decide ``correct``, and the plain
reference's readings of the same steps.

A reading is what a comparison needs and nothing more: each step's loss,
the networks' outputs in the first step and the norm of each row of the
loss's gradient with respect to each disparity (on the program's side
taken by forward and tensor hooks from the step's own call), the norm of each
leaf of the first gradient as the optimizer got it (Adam's first moment
after one update, over 1 - beta1), and the norm of each leaf's change
after the checked steps, all in float64.
"""

from __future__ import annotations

import copy
import functools
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from benchmark import inputs
from benchmark.reference import nets, train

CHECK_STEPS = 3


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

    kind = ""  # "vo" or "depth"

    def __init__(self, cell, seed: int, device: torch.device, mesh, batch: int,
                 height: int, width: int, pool: int, fault: Optional[str] = None):
        self.seed, self.device, self.mesh = seed, device, mesh
        self.batch, self.height, self.width, self.pool_size = batch, height, width, pool
        self.world = mesh.world if mesh is not None else 1
        self.rank = mesh.rank if mesh is not None else 0
        self.fault = fault
        self.config = cell.config
        self.dtype = getattr(torch, self.config["compute_dtype"])
        self.optim = self.config["optimizer"]
        start = time.perf_counter()
        self.init_weights = inputs.draw_weights(self.config, seed, device)
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
    def build_models(self) -> Dict[str, torch.nn.Module]:
        raise NotImplementedError

    def build_step(self, mesh):
        raise NotImplementedError

    def draw_entry(self, gen_batch, gen_noise, B: int) -> Dict:
        """One pool entry of ``B`` rows: ``{"batch": ..., "noise": ... or None}``."""
        raise NotImplementedError

    def call_step(self, entry: Dict) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def loss_config(self) -> Dict:
        """The loss's settings as the reference takes them."""
        return self.config["loss"]

    @staticmethod
    def ordered_outputs(out) -> List[torch.Tensor]:
        """A network's output tensors in the reference's order: DepthNet's
        disparities by scale, PoseNet's axis-angles, then translations."""
        return [out[k] for k in sorted(out)] if isinstance(out, dict) else list(out)

    @classmethod
    def flat_outputs(cls, out) -> List[torch.Tensor]:
        """A network's outputs in the reference's order and shapes:
        DepthNet's disparities by scale, PoseNet's [N, 3] pairs."""
        tensors = cls.ordered_outputs(out)
        return tensors if isinstance(out, dict) else [o.reshape(o.shape[0], -1) for o in tensors]

    def reference_rows(self, outputs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The reference's global outputs cut to this rank's rows (PoseNet's
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
                if name != "depth.":
                    return
                for t in self.ordered_outputs(out):
                    ddisp.append(None)
                    if t.requires_grad:
                        t.register_hook(functools.partial(keep_ddisp, len(ddisp) - 1))
            return hook

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
        weights = inputs.draw_weights(self.config, self.seed, self.device)
        init = {k: v.clone() for k, v in weights.items()}
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            out = train.run_steps(
                self.kind, weights, [e["batch"] for e in entries],
                [e["noise"] for e in entries if e["noise"] is not None],
                self.loss_config(), self.optim, precision)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return {"losses": out["losses"], "grad": leaf_norms(out["first_grad"]),
                "change": leaf_norms({k: v - init[k] for k, v in out["params"].items()}),
                "ranks": None,
                "outputs": [o.float().cpu() for o in self.reference_rows(out["first_outputs"])],
                "ddisp": [row_norms(d) for d in self.reference_rows(out["first_ddisp"])]}


def _load(model: torch.nn.Module, weights: Dict[str, torch.Tensor], prefix: str) -> None:
    """The seed's weights into ``model`` by name; BatchNorm's running
    statistics at their initial values. The names must match exactly."""
    names = {n for n, _ in model.named_parameters()}
    want = {k[len(prefix):] for k in weights if k.startswith(prefix)}
    if names != want:
        raise RuntimeError(f"the program's {prefix[:-1]} parameters differ from the "
                           f"reference's: {sorted(names ^ want)[:6]}")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[prefix + n])
        for n, b in model.named_buffers():
            if n.endswith("running_var"):
                b.fill_(1)
            else:
                b.zero_()
