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
  of the run. Then the graph is captured, which runs nothing (twice: the
  recorder's timed copy, below). A graph key picks the graph of a step:
  the joint step's warmup flag, so that its warmup steps and its live ones
  have a graph each.
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
and the kernels' launch counts (``kernels.build.launches``), puts them
back (capturing ran nothing), and adds the same at every replay, so the
counts count the launches on the card. A
failed capture or replay raises; nothing falls back to eager steps on the
card.

The recorder (utils/profiling.py) sees the dispatch from inside while
torch.profiler records: the spans ``nst.dispatch.run`` and, inside it,
``nst.dispatch.upload``, ``nst.dispatch.launch`` (each ``graph.replay()``)
and ``nst.dispatch.first_step`` (the eager step and the captures); the
counts ``nst.dispatch.replays`` and ``nst.dispatch.queued_steps`` (the
chunk's steps the device has not finished when ``run`` returns, from an
event recorded after each step); ``nst.dispatch.read``; and, after the
read's host sync, the phase times of the chunk's last step
(``nst.step.<phase>``). Each step graph is captured twice: as it runs, and
timed, with the events of its phase markers as nodes; a replay takes the
timed graph only while the recorder is on, so a run with no profiler
replays graphs with no event in them. Under a profiler of the card's
activity (CUPTI), a graph launch costs the host milliseconds and the
launch queue holds fewer steps, so the launch times and the queue read
as they are without one only under a profiler of the host alone
(``scripts/probe_dispatch.py``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Hashable, Sequence

import numpy as np
import torch

from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.train.state import TrainState, schedule_lr
from nerf_sampling_tpu_torch.train.steps import StepSeed
from nerf_sampling_tpu_torch.utils import profiling

@dataclasses.dataclass
class _StepGraph:
    """A step captured twice: as it runs, and with its phase markers as
    event nodes (``timed``), which the dispatcher replays while the
    recorder is on."""

    graph: torch.cuda.CUDAGraph
    metrics: torch.Tensor  # [M], in the graph's memory
    timed: torch.cuda.CUDAGraph
    timed_metrics: torch.Tensor  # [M], in the timed graph's memory
    phases: profiling.PhaseClock  # the timed graph's phase markers
    advances: list[tuple[object, str, int]]  # (owner, counter, what one step adds)
    launches: collections.Counter  # what one step adds to build.launches

    def replay(self, timed: bool) -> torch.Tensor:
        with profiling.span("nst.dispatch.launch"):
            (self.timed if timed else self.graph).replay()
        for owner, name, d in self.advances:
            setattr(owner, name, getattr(owner, name) + d)
        build.launches.update(self.launches)
        return self.timed_metrics if timed else self.metrics


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
        self._last_timed: _StepGraph | None = None  # the graph of the chunk's last step, if a timed replay
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._row: torch.Tensor | None = None  # the static [N, 9] input
            self._seed = StepSeed(torch.zeros((), dtype=torch.int32, device=self.device),
                                  torch.Generator(device=self.device))
            self._done: list[torch.cuda.Event] = []  # while the recorder is on, an event after each step

    @property
    def graphs(self) -> int:
        """How many CUDA graphs the steps have captured (0 off the card)."""
        return len(self._graphs)

    def _upload(self, stack: np.ndarray, seeds: Sequence[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """The [K, N, 9] fp32 stack and the K seeds on the device, in one copy."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(stack, np.float32)).to(self.device), None
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

    def _body(self, row: torch.Tensor, seed: int | StepSeed,
              timed: bool | None = None) -> tuple[torch.Tensor, profiling.PhaseClock | None]:
        """A step's metrics [M] and, on the card where ``timed`` (by
        default, while the recorder is on), its phase events."""
        batch = (row[:, 0:3].contiguous(), row[:, 3:6].contiguous(), row[:, 6:9].contiguous())
        with profiling.step_phases(self.device, timed) as phases:
            m = self.step(batch, seed)
        return self._metrics(m), phases

    def run(self, stack: np.ndarray, seeds: Sequence[int]) -> torch.Tensor:
        """The steps of one chunk, from the [K, N, 9] stack and the K seeds;
        returns their metrics [K, M] (``names``' order) on the device, with
        no host sync on the card."""
        with profiling.span("nst.dispatch.run"):
            return self._run(stack, seeds)

    def _run(self, stack: np.ndarray, seeds: Sequence[int]) -> torch.Tensor:
        if len(seeds) != stack.shape[0]:
            raise ValueError(f"{stack.shape[0]} batches but {len(seeds)} seeds")
        with profiling.span("nst.dispatch.upload"):
            rows, seeds_d = self._upload(stack, seeds)
        if self.device.type != "cuda":
            return torch.stack([self._body(rows[j], int(s))[0] for j, s in enumerate(seeds)])
        if self._row is None:
            self._row = torch.empty_like(rows[0])
        elif self._row.shape != rows.shape[1:]:
            raise ValueError(f"the captured steps take [{self._row.shape[0]}, 9] batches, got {tuple(rows.shape[1:])}")
        on = profiling.recording()
        if on:
            self._done += [torch.cuda.Event() for _ in range(len(seeds) - len(self._done))]
        out = None
        replays = 0
        for j, s in enumerate(seeds):
            self._row.copy_(rows[j])
            self._seed.k6.copy_(seeds_d[j])
            self._seed.generator.manual_seed(int(s))
            for state in self.states:
                schedule_lr(state)
            key = self.graph_key()
            g = self._graphs.get(key)
            if g is not None:
                m = g.replay(on)
                self._last_timed = g if on else None
                replays += 1
            else:
                with profiling.span("nst.dispatch.first_step"):
                    m = self._first_step(key)
                self._last_timed = None  # an eager step's phases are added by profiling.settle
            if out is None:
                out = torch.empty((len(seeds), m.numel()), dtype=m.dtype, device=self.device)
            out[j].copy_(m)
            if on:
                self._done[j].record()
        if on:
            profiling.count("nst.dispatch.replays", replays)
            profiling.count("nst.dispatch.queued_steps", sum(not e.query() for e in self._done[:len(seeds)]))
        return out

    def read(self, metrics: torch.Tensor) -> dict[str, np.ndarray]:
        """A chunk's metrics on the host: name -> [K] (one copy); while the
        recorder is on, then the phase times of the chunk's last step."""
        with profiling.span("nst.dispatch.read"):
            host = metrics.cpu().numpy()
        if profiling.recording():
            profiling.settle()
            if self._last_timed is not None:
                self._last_timed.phases.add()
        return {k: host[:, i] for i, k in enumerate(self.names)}

    def _first_step(self, key: Hashable) -> torch.Tensor:
        """The first step of graph ``key``, eagerly on the side stream, then
        the graph's capture from the same static inputs."""
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            metrics, _ = self._body(self._row, self._seed)
        current.wait_stream(self._stream)
        pairs = [(s, attr) for s in self.states for attr in ("step", "updates")]
        before = [getattr(o, n) for o, n in pairs]
        launched = build.launches.copy()
        captured = []
        for timed in (False, True):
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self._seed.generator)
            with torch.cuda.graph(graph, stream=self._stream):
                out, phases = self._body(self._row, self._seed, timed)
            captured += [graph, out]
            advances = []
            for (owner, name), b in zip(pairs, before):
                a = getattr(owner, name)
                setattr(owner, name, b)
                if a is not None and b is not None and a != b:
                    advances.append((owner, name, a - b))
            launches = build.launches - launched
            build.launches.clear()
            build.launches.update(launched)
        self._graphs[key] = _StepGraph(*captured, phases, advances, launches)
        return metrics
