"""Runner ``train_dp``: ``runners/train.py``'s step on ``ranks`` cards at once,
data parallel in one process group (NCCL on the cards, gloo on the CPU).

The harness's process is rank 0 on card 0.  It starts ranks 1.. as
processes of this module, each on its own card, and drives them step for
step: it sends the cell on each worker's standard input, then, before each
of its own units, the unit's index; a worker runs the same unit on its own
batch, and the collectives inside the step keep the ranks together.  Every
rank draws its pool of raw batches from the seed and its rank; the weights
and the dropout generator come from the seed alone, so every rank starts
from the same state.  The trainer runs over a ``(ranks, 1)`` mesh: BatchNorm
statistics, dropout masks, the contrastive candidates and the CTC normaliser
are the global batch's, and the gradients are averaged by one all-reduce
(``MultiSpeakerTrainer._average_grads``).

Nothing waits without a deadline: the workers' start-up (``READY_S``), the
group's set-up and every collective (``GROUP_S``, the group's timeout), and
the group's end (``EXIT_S``).  A watchdog thread in rank 0 ends the process
with exit code 1 when a worker ends before it was told to stop; a worker
ends when rank 0 closes its input or ends.  NCCL's communicators are
destroyed by every rank together (the destroy waits for the other ranks), so
rank 0 destroys its own while the workers destroy theirs.

``train_utt_per_s`` counts the global batch.  The check replays the first
steps in the reference at the global batch (the ranks' batches in rank
order) and compares rank 0's log-probabilities (its rows, the global batch's
first) and gradient and change (global after the all-reduce) with the train
runner's numbers and limits.  A traced run times the all-reduce on rank 0's
stream (``allreduce``).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from .. import harness, traffic
from . import common, train

KIND = "train"
READY_S = 300.0
GROUP_S = 180.0
EXIT_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_pool(mix: dict, seed: int, rank: int) -> list[dict]:
    """Rank ``rank``'s raw batches: drawn from the seed and the rank."""
    return traffic.raw_batches(mix, [seed, rank])


def global_pool(mix: dict, seed: int) -> list[dict]:
    """The global batches: each key of every rank's batch, in rank order."""
    pools = [rank_pool(mix, seed, r) for r in range(mix["ranks"])]
    return [{k: np.concatenate([p[i][k] for p in pools]) for k in pools[0][i]}
            for i in range(len(pools[0]))]


def _join_group(device: str, rank: int, world: int, port: int) -> None:
    import torch.distributed as dist

    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_S))


class Job(train.Job):
    def __init__(self, ctx, rank: int = 0, port: int | None = None):
        import torch

        from multimodal_av_model_tpu_torch.data.device_pipeline import (
            device_preprocessed_batches,
        )
        from multimodal_av_model_tpu_torch.parallel import make_mesh, parallelize
        from multimodal_av_model_tpu_torch.train.trainer import MultiSpeakerTrainer, TrainState

        self.ctx, self.mix, self.rank = ctx, ctx.mix, rank
        world = self.mix["ranks"]
        if ctx.device == "cuda":
            torch.cuda.set_device(rank)
        self.device = ctx.device
        self.workers, self._stopping, self._lines = [], False, queue.Queue()
        if rank == 0:
            port = free_port()
            self._start_workers(port)
        _join_group(self.device, rank, world, port)
        self._preprocess = device_preprocessed_batches
        self.pool = rank_pool(self.mix, ctx.seed, rank)
        model, self.template = common.seeded_model(ctx)
        mesh = make_mesh(world, device_type=self.device)
        parallelize(model, mesh)
        self.trainer = MultiSpeakerTrainer(ctx.config, model, None, device=self.device,
                                           mesh=mesh)
        gen = torch.Generator(device=self.device).manual_seed(ctx.dropout_seed)
        self.state = TrainState(0, model, self.trainer.make_optimizer(), gen)
        self.next_unit = self.mix["warmup"]
        self.failed_units = 0
        self.metrics = None
        self._timed = []
        if rank == 0:
            self._await_ready()

    # -- rank 0's workers ---------------------------------------------------------

    def _start_workers(self, port: int) -> None:
        cell = self.ctx.cell
        spec = json.dumps({"cell": dataclasses.asdict(cell), "seed": self.ctx.seed,
                           "device": self.ctx.device, "port": port})
        env = {**os.environ, "PYTHONUNBUFFERED": "1"}
        for r in range(1, self.mix["ranks"]):
            p = subprocess.Popen([sys.executable, "-m", "avbench.runners.train_dp", str(r)],
                                 cwd=harness.ROOT, env=env, stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, text=True)
            p.stdin.write(spec + "\n")
            p.stdin.flush()
            self.workers.append(p)
            threading.Thread(target=self._read, args=(r, p), daemon=True).start()
        threading.Thread(target=self._watch, daemon=True).start()

    def _read(self, r: int, p) -> None:
        for line in p.stdout:
            self._lines.put((r, line.strip()))

    def _watch(self) -> None:
        while not self._stopping:
            for r, p in enumerate(self.workers, 1):
                if p.poll() is not None and not self._stopping:
                    print(f"train_dp: rank {r} ended (exit code {p.returncode}) before it "
                          "was told to stop", file=sys.stderr, flush=True)
                    os._exit(1)
            time.sleep(0.5)

    def _await_ready(self) -> None:
        deadline = time.monotonic() + READY_S
        waiting = set(range(1, self.mix["ranks"]))
        while waiting:
            try:
                r, line = self._lines.get(timeout=max(deadline - time.monotonic(), 0.0))
            except queue.Empty:
                self._stop_workers(kill=True)
                raise SystemExit(f"train_dp: ranks {sorted(waiting)} not ready within "
                                 f"{READY_S:.0f} s") from None
            if line == "ready":
                waiting.discard(r)

    def _send(self, command: str) -> None:
        for p in self.workers:
            p.stdin.write(command + "\n")
            p.stdin.flush()

    def _stop_workers(self, kill: bool = False) -> None:
        """End the workers: closing their input ends each one's loop, and
        this rank leaves the group beside them (``close`` here is bounded by
        ``EXIT_S``); a worker still running after that is killed."""
        self._stopping = True
        for p in self.workers:
            if kill:
                p.kill()
            else:
                try:
                    p.stdin.close()
                except OSError:
                    pass
        if not kill:
            bounded(self.close)
        for r, p in enumerate(self.workers, 1):
            try:
                p.wait(timeout=EXIT_S)
            except subprocess.TimeoutExpired:
                print(f"train_dp: rank {r} still running {EXIT_S:.0f} s after its input "
                      "closed: killed", file=sys.stderr, flush=True)
                p.kill()
                p.wait(10)
            if p.returncode and p.returncode > 0 and not kill:
                raise SystemExit(f"train_dp: rank {r} exited with code {p.returncode}")

    # -- the timed path -------------------------------------------------------------

    def unit(self, i: int, spans=None) -> None:
        if self.rank == 0:
            self._send(f"unit {i}")
        super().unit(i, spans)
        if spans is not None:
            self.sync()
            for start, end in self._timed:
                spans.add("allreduce", start.elapsed_time(end) / 1e3)
            self._timed = []

    def attach(self, spans) -> None:
        """Times ``_average_grads`` on the stream: the all-reduce and its
        flattening and copy back."""
        import torch

        average = self.trainer._average_grads

        def timed(params, group):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            average(params, group)
            end.record()
            self._timed.append((start, end))

        if self.device == "cuda":
            self.trainer._average_grads = timed

    # -- results --------------------------------------------------------------------

    def end_to_end(self, lat, window_s: float) -> dict:
        return {"train_utt_per_s": self.mix["ranks"] * self.mix["batch"] * len(lat) / window_s}

    def close(self) -> None:
        """Leave the group (after every rank's last collective)."""
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()

    def check(self) -> dict:
        loss = float(self.metrics["loss"])
        B = self.mix["batch"]
        if not np.isfinite(loss) or any(lp.shape[0] != B for lp in self.program["lp"]):
            self.failed_units += 1
        self._stop_workers()
        del self.state, self.trainer, self.metrics
        common.free(self.device)
        whole = {**self.mix, "batch": self.mix["ranks"] * B}
        ctx = dataclasses.replace(self.ctx, cell=dataclasses.replace(self.ctx.cell, mix=whole))
        ref = train.reference_steps(ctx, self.template, global_pool(self.mix, self.ctx.seed),
                                    self.mix["check_steps"])
        out = train.compare(self.program, ref, detail=True)
        self.detail = out.pop("detail")
        return out


def bounded(fn) -> None:
    """``fn()`` on a daemon thread, waited for at most ``EXIT_S``."""
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    t.join(EXIT_S)


def worker(rank: int) -> None:
    """A rank above 0: the cell from the first line of standard input, then
    one unit per ``unit <i>`` line, until the input ends; then it leaves the
    group and ends the process."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parent = os.getppid()

    def orphaned():
        while True:
            if os.getppid() != parent:
                os._exit(1)
            time.sleep(1.0)

    threading.Thread(target=orphaned, daemon=True).start()
    spec = json.loads(sys.stdin.readline())
    cell = harness.Cell(**spec["cell"])
    ctx = harness.make_context(cell, spec["seed"], spec["device"])
    job = Job(ctx, rank=rank, port=spec["port"])
    print("ready", flush=True)
    for line in sys.stdin:
        job.unit(int(line.split()[1]))
    job.sync()
    bounded(job.close)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    worker(int(sys.argv[1]))
