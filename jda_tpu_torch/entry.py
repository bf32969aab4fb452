"""Entry points: the flagship forward step and the multi-device dry run.

PyTorch counterpart of the repository's `__graft_entry__.py`:

  * `entry(device)` returns the full-cascade forward of the flagship model
    (T=5, K=540, 27 landmarks, depth 4) over a batch of windows, with its
    arguments;
  * `dryrun_multichip(n)` runs the sharded paths once on n ranks:
    detection data-parallel over windows and over images, and the
    sample-sharded split search and Trainer;
  * `run_on_mesh(fn, n, ...)` (or `MeshRun`, which returns at once)
    starts an SPMD group of n spawned processes, one per rank, builds a
    1-D DeviceMesh over "dp" in each and returns fn(mesh, ...)'s result of
    every rank.

A mesh run by hand follows the same recipe as run_on_mesh: one process
per device, `torch.distributed.init_process_group` with its rank, the
world size, a store every rank can reach (a `file://` path on one host,
`tcp://host:port` across hosts) and a timeout; `torch.cuda.set_device` on
the local rank; `init_device_mesh(device_type, (n,),
mesh_dim_names=("dp",))`; then the same program with the same config,
data and seed on every rank.
"""

from __future__ import annotations

import datetime
import functools
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from jda_tpu_torch.utils import resolve_device


def _flagship(seed: int = 0):
    from jda_tpu_torch.params import synthetic_model

    return synthetic_model(T=5, K=540, landmark_n=27, seed=seed, reject_rate=0.1)


def _example_inputs(m, device: torch.device, n_windows: int = 256, img_hw=(96, 128)):
    """(flat pyramid buffer, window state) of the first n_windows windows
    of a random img_hw image's ladder (scale 1.25, windows 24-64 px)."""
    from jda_tpu_torch.detect import enumerate_windows, window_geometry
    from jda_tpu_torch.ops import cascade as C
    from jda_tpu_torch.ops import resize as R

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, img_hw).astype(np.uint8)
    flat, offsets, strides = R.stack_pyramid(R.pyramid_c(img))
    x, y, win, _ = enumerate_windows(img_hw[1], img_hw[0], 1.25, 24, 64)
    n = min(n_windows, len(x))
    geom = window_geometry(x[:n], y[:n], win[:n], offsets, strides)

    def t(a):
        return torch.as_tensor(a, device=device)

    state = C.init_state(
        n, t(m.mean_shape.astype(np.float32)), t(geom["base"]), t(geom["stride"]),
        t(geom["pw"]), t(geom["ph"]), torch.ones(n, dtype=torch.bool, device=device),
    )
    return t(flat), state


def entry(device: Union[str, torch.device, None] = None) -> Tuple[Callable, tuple]:
    """(fn, args): ops/cascade.cascade_full of the flagship model over 256
    windows of a 96x128 image, C-API truncation, exact regression, on
    `device` (CUDA unless named)."""
    from jda_tpu_torch.ops import cascade as C

    device = resolve_device(device)
    m = _flagship()
    flat_img, state = _example_inputs(m, device)
    fn = functools.partial(
        C.cascade_full, depth=m.tree_depth, rounding=False, leaf_n=m.leaf_n,
        T=m.T, exact=True, single_scale=True,
    )
    return fn, (m.device_tensors(device, torch.float32), flat_img, state)


# -- SPMD groups ----------------------------------------------------------


def _rank_main(rank, n, store, backend, device_type, timeout, fn, args, results):
    """One rank: join the group, build the mesh, run fn, report."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            torch.cuda.init()
        else:
            torch.set_num_threads(1)  # n ranks share the host's cores
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout),
        )
        mesh = init_device_mesh(device_type, (n,), mesh_dim_names=("dp",))
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class MeshRun:
    """fn(mesh, *args) in n spawned processes, one per rank, each over a
    1-D DeviceMesh ("dp") of the n ranks; `results()` waits for the ranks'
    results, in rank order.  `fn` and its arguments are pickled: fn must
    be importable by module name.

    device: CUDA unless "cpu" is named (rank r on card r modulo the cards;
    without CUDA the default raises; on the CPU each rank runs one PyTorch
    thread).  backend: NCCL on the card, gloo on the CPU, unless named
    (gloo also serves CUDA tensors, so two ranks can share one card).  NCCL
    wants a card per rank and raises with fewer.  timeout bounds each
    collective (init_process_group's timeout), limit the whole run, from
    the start: a rank that fails, dies or outlives it raises in results(),
    which stops every process before it returns."""

    def __init__(
        self,
        fn: Callable,
        n: int,
        *args,
        device: Union[str, torch.device, None] = None,
        backend: Union[str, None] = None,
        timeout: float = 120.0,
        limit: float = 600.0,
    ):
        device_type = resolve_device(device).type
        backend = backend or ("nccl" if device_type == "cuda" else "gloo")
        if backend == "nccl" and torch.cuda.device_count() < n:
            raise RuntimeError(
                f"NCCL needs a card per rank: {n} ranks, {torch.cuda.device_count()} "
                "cards (backend='gloo' runs several ranks on one card)"
            )
        self.n = n
        self.deadline = time.monotonic() + limit
        self.limit = limit
        ctx = torch.multiprocessing.get_context("spawn")
        self._queue = ctx.Queue()
        self._tmp = tempfile.TemporaryDirectory(prefix="jda_mesh_")
        store = os.path.join(self._tmp.name, "store")
        self._procs = [
            ctx.Process(
                target=_rank_main,
                args=(r, n, store, backend, device_type, timeout, fn, args, self._queue),
                daemon=True,
            )
            for r in range(n)
        ]
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.close()
            raise

    def results(self) -> List:
        got: Dict[int, object] = {}
        try:
            while len(got) < self.n:
                left = self.deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"mesh run of {self.n} ranks outlived {self.limit} s")
                try:
                    rank, ok, out = self._queue.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} died (exit code {self._procs[dead[0]].exitcode})"
                        )
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {self.n} failed:\n{out}")
                got[rank] = out
        finally:
            # ranks that reported leave their group and exit; others are killed
            self.close(wait=30.0 if len(got) == self.n else 0.0)
        return [got[r] for r in range(self.n)]

    def close(self, wait: float = 0.0) -> None:
        """Stop every rank: wait up to `wait` s for each to exit, then kill
        it.  Safe to call more than once."""
        for p in self._procs:
            if p.pid is not None:
                p.join(timeout=wait)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        self._queue.close()
        self._tmp.cleanup()


def run_on_mesh(fn: Callable, n: int, *args, **kw) -> List:
    """MeshRun(fn, n, *args, **kw).results(): fn(mesh, *args) on n ranks."""
    return MeshRun(fn, n, *args, **kw).results()


def run_each(mesh, calls: Sequence[Tuple[Callable, tuple]]) -> List:
    """[fn(mesh, *args) for fn, args in calls]: several rank bodies in one
    group, so that they share its start-up."""
    return [fn(mesh, *args) for fn, args in calls]


# -- the multi-device dry run --------------------------------------------


def _dryrun_rank(mesh) -> Dict:
    """The four steps of dryrun_multichip on one rank."""
    from jda_tpu_torch.detect import Detector
    from jda_tpu_torch.ops import cascade as C
    from jda_tpu_torch.params import synthetic_model
    from jda_tpu_torch.train.dryrun import sharded_train_step_dryrun, sharded_trainer_dryrun
    from jda_tpu_torch.train.sharded import ShardedOps

    ops = ShardedOps(mesh)
    n = ops.nd

    # detection, data-parallel over windows: each rank its slab
    m = _flagship()
    n_win = 32 * n
    flat_img, state = _example_inputs(m, ops.device, n_windows=n_win)
    assert state["score"].shape[0] == n_win
    rows = ops.shard(n_win)
    out = C.cascade_full(
        m.device_tensors(ops.device, torch.float32), flat_img,
        {k: v[rows] for k, v in state.items()}, depth=m.tree_depth, rounding=False,
        leaf_n=m.leaf_n, T=m.T, exact=False, single_scale=True,
    )
    score = ops.gather(out["score"], n_win)
    assert score.shape == (n_win,) and bool(torch.isfinite(score).all())

    # detection, data-parallel over images (the production path)
    rng = np.random.default_rng(1)
    m_small = synthetic_model(T=2, K=16, landmark_n=5, seed=2, reject_rate=0.05)
    det = Detector(m_small, device=ops.device)
    imgs = [rng.integers(0, 256, (48, 64)).astype(np.uint8) for _ in range(n + 1)]
    results = det.detect_batch(imgs, scale=1.3, th=-10.0, mesh=mesh)
    assert len(results) == len(imgs)
    for a, b in zip(results, det.detect_batch(imgs, scale=1.3, th=-10.0)):
        assert np.array_equal(a.bboxes, b.bboxes) and np.array_equal(a.scores, b.scores)

    # training: the sharded split-search step, then one real cart
    sharded_train_step_dryrun(mesh)
    sharded_trainer_dryrun(mesh)
    return {"windows": n_win, "boxes": [r.n for r in results], "collectives": ops.collective_stats()}


def dryrun_multichip(
    n: int,
    device: Union[str, torch.device, None] = None,
    backend: Union[str, None] = None,
) -> List[Dict]:
    """One sharded step of detection and training on n ranks: cascade_full
    over 32 n windows (exact=False), detect_batch(mesh=) on n + 1 images of
    48x64, sharded_train_step_dryrun and sharded_trainer_dryrun.  NCCL on
    the card by default (a card per rank; fewer raise); gloo on the CPU
    (device="cpu") or on the card when named.  Returns each rank's
    summary."""
    return run_on_mesh(_dryrun_rank, n, device=device, backend=backend)
