"""K train steps per host sync (nerf_sampling_tpu/train/steps.py:284-360 ``make_multi_step``).

The JAX package fuses K steps into one dispatch with ``lax.scan``.
``StepDispatcher`` runs such a chunk: K steps from a [K, N, 9] stack of
ray batches (rays_o, rays_d and target, per row) and their K int seeds,
returning the steps' metrics as one [K, M] tensor that the caller reads
back once per chunk.

- On the card each step graph is captured once (a CUDA graph of one whole
  step: the forward, the backward, the Adam updates and the metrics), and
  every later step that takes it is a replay. The graph reads static inputs:
  a [N, 9] row, K6's seed word and the generator of the torch draws
  (``StepSeed``, registered with the graph). Before each replay, with no
  host sync, the row is copied from the chunk's stack on the device, the
  seed word from the chunk's seed vector, the generator is reseeded from
  the host (which sets the seed that the replay writes to the device), and
  the NeRF's learning rate is filled from the host schedule; after it the
  step's metrics are copied into row j of the chunk's [K, M] buffer. Per
  chunk there is one host-to-device copy (the stack and the seeds) and one
  device-to-host copy (the metrics).
  The first step of each graph runs eagerly on the capture's side stream:
  it fills the kernels' caches, creates the Adam state, and is a real step
  of the run. Then the graph is captured, which runs nothing. A graph key
  picks the graph of a step: the joint step's warmup flag, so that its
  warmup steps and its live ones have a graph each.
- On the CPU the chunk runs its steps eagerly one after the other, the
  plain path, as for every kernel.

Either way a chunk equals its K steps run one by one, bit for bit, as the
scan does in JAX.

On a mesh of ranks (JAX ``make_multi_step(mesh=)``) the step is the rank's
sharded one (parallel/ops.py), its gradient and metric all-reduces inside
it. Under nccl they are captured with the rest of the step: torch's NCCL
process group joins its stream to the capture through an event and the
step's stream waits on the collective's end event, so the host neither
copies nor waits, and a replay runs the step and its collectives. Every
rank captures the same graphs in the same order (the graph key is a
function of the step count, which every rank shares), the first, eager
step of each graph brings the communicator up before any capture, and the
replays and the eager collectives between chunks (the evals' gathers, the
barriers) are issued in one order on one communicator by every rank.
gloo's collectives copy through the host, which no graph can hold, so on
the card a gloo mesh runs per step (train/trainer.py).

A replay runs no Python, so the host side of a step is repeated here: the
capture records how far the step moved each state's step and update counts
and each kernel's launch counter (the ``*launches`` integers of
``kernels.fused_*``), puts them back (capturing ran nothing), and adds the
same at every replay, so the counters count the launches on the card. A
failed capture or replay raises; nothing falls back to eager steps on the
card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Hashable, Sequence

import numpy as np
import torch

from nerf_sampling_tpu_torch.kernels import fused_depth_net, fused_hier, fused_nerf, fused_nerf_vjp, fused_render
from nerf_sampling_tpu_torch.train.state import TrainState, schedule_lr
from nerf_sampling_tpu_torch.train.steps import StepSeed

_COUNTED = (fused_depth_net, fused_hier, fused_nerf, fused_nerf_vjp, fused_render)


def _host_counters(states: Sequence[TrainState]) -> list[tuple[object, str]]:
    """The host counters a step moves: each state's step and update counts
    and every kernel wrapper's launch counter."""
    pairs = [(s, attr) for s in states for attr in ("step", "updates")]
    pairs += [(m, name) for m in _COUNTED for name, v in vars(m).items()
              if name.endswith("launches") and isinstance(v, int)]
    return pairs


@dataclasses.dataclass
class _StepGraph:
    graph: torch.cuda.CUDAGraph
    metrics: torch.Tensor  # [M], in the graph's memory
    advances: list[tuple[object, str, int]]  # (owner, counter, what one step adds)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        for owner, name, d in self.advances:
            setattr(owner, name, getattr(owner, name) + d)
        return self.metrics


class StepDispatcher:
    """Chunks of steps of ``step(batch, seed) -> metrics``, where ``batch``
    is (rays_o, rays_d, target) and ``seed`` an int or a ``StepSeed``;
    ``states`` are the train states the step updates in place, and
    ``graph_key()``, called before each step, names the graph it takes on
    the card (module docstring)."""

    def __init__(self, step: Callable[[tuple, int | StepSeed], dict], states: Sequence[TrainState],
                 device: torch.device | str, graph_key: Callable[[], Hashable] = lambda: None):
        self.step, self.states, self.graph_key = step, list(states), graph_key
        self.device = torch.device(device)
        self.names: list[str] | None = None  # the metrics' order, from the first step
        self._graphs: dict[Hashable, _StepGraph] = {}
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._row: torch.Tensor | None = None  # the static [N, 9] input
            self._seed = StepSeed(torch.zeros((), dtype=torch.int32, device=self.device),
                                  torch.Generator(device=self.device))

    @property
    def graphs(self) -> int:
        """How many CUDA graphs the steps have captured (0 off the card)."""
        return len(self._graphs)

    def _upload(self, stack: np.ndarray, seeds: Sequence[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """The [K, N, 9] fp32 stack and the K seeds on the device, in one copy."""
        flat = np.empty(stack.nbytes + 4 * len(seeds), np.uint8)
        flat[:stack.nbytes] = np.ascontiguousarray(stack, np.float32).reshape(-1).view(np.uint8)
        flat[stack.nbytes:] = np.asarray(seeds, np.int32).view(np.uint8)
        dev = torch.from_numpy(flat).to(self.device)
        return dev[:stack.nbytes].view(torch.float32).view(stack.shape), dev[stack.nbytes:].view(torch.int32)

    def _metrics(self, m: dict) -> torch.Tensor:
        if self.names is None:
            self.names = list(m)
        if list(m) != self.names:
            raise ValueError(f"a step's metrics changed from {self.names} to {list(m)}")
        return torch.stack([m[k].reshape(()).float() for k in self.names])

    def _body(self, row: torch.Tensor, seed: int | StepSeed) -> torch.Tensor:
        batch = (row[:, 0:3].contiguous(), row[:, 3:6].contiguous(), row[:, 6:9].contiguous())
        return self._metrics(self.step(batch, seed))

    def run(self, stack: np.ndarray, seeds: Sequence[int]) -> torch.Tensor:
        """The steps of one chunk, from the [K, N, 9] stack and the K seeds;
        returns their metrics [K, M] (``names``' order) on the device, with
        no host sync on the card."""
        if len(seeds) != stack.shape[0]:
            raise ValueError(f"{stack.shape[0]} batches but {len(seeds)} seeds")
        if self.device.type != "cuda":
            rows = torch.from_numpy(np.ascontiguousarray(stack, np.float32)).to(self.device)
            return torch.stack([self._body(rows[j], int(s)) for j, s in enumerate(seeds)])
        rows, seeds_d = self._upload(stack, seeds)
        if self._row is None:
            self._row = torch.empty_like(rows[0])
        elif self._row.shape != rows.shape[1:]:
            raise ValueError(f"the captured steps take [{self._row.shape[0]}, 9] batches, got {tuple(rows.shape[1:])}")
        out = None
        for j, s in enumerate(seeds):
            self._row.copy_(rows[j])
            self._seed.k6.copy_(seeds_d[j])
            self._seed.generator.manual_seed(int(s))
            for state in self.states:
                schedule_lr(state)
            key = self.graph_key()
            g = self._graphs.get(key)
            m = g.replay() if g is not None else self._first_step(key)
            if out is None:
                out = torch.empty((len(seeds), m.numel()), dtype=m.dtype, device=self.device)
            out[j].copy_(m)
        return out

    def read(self, metrics: torch.Tensor) -> dict[str, np.ndarray]:
        """A chunk's metrics on the host: name -> [K] (one copy)."""
        host = metrics.cpu().numpy()
        return {k: host[:, i] for i, k in enumerate(self.names)}

    def _first_step(self, key: Hashable) -> torch.Tensor:
        """The first step of graph ``key``, eagerly on the side stream, then
        the graph's capture from the same static inputs."""
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            metrics = self._body(self._row, self._seed)
        current.wait_stream(self._stream)
        pairs = _host_counters(self.states)
        before = [getattr(o, n) for o, n in pairs]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._seed.generator)
        with torch.cuda.graph(graph, stream=self._stream):
            out = self._body(self._row, self._seed)
        advances = []
        for (owner, name), b in zip(pairs, before):
            a = getattr(owner, name)
            setattr(owner, name, b)
            if a is not None and b is not None and a != b:
                advances.append((owner, name, a - b))
        self._graphs[key] = _StepGraph(graph, out, advances)
        return metrics
