"""The kNN loop as one CUDA graph: a WHILE conditional node over a round.

Replaces the control of the reference's ``lax.while_loop`` in
``repro/core/executor.py`` (``_knn_rounds``): ``cond`` is ``~all(done) &
(rounds < max_rounds)``, ``rounds + 1`` ends every body.  On the card
(``csrc/graph_loop.cu``) a :class:`WhileGraph` holds a WHILE node whose
body is one captured round (a PyTorch ``CUDAGraph(keep_graph=True)``,
added as a child graph) followed by the one-thread kernel
``knn_loop_cond``, which adds one to ``rounds`` and sets the node's
condition; one launch runs every round the batch needs, with no host
sync between rounds.  :func:`loop_cond_plain` is that kernel's plain
version, which the CPU loop runs between its rounds.

Launches are counted where they run: the round's kernels and
``knn_loop_cond`` once per round a replay ran (the caller reads the
rounds back and calls ``_cuda.add_launches``); :func:`loop_rounds`, the
condition alone in a WHILE graph (its check on the card), counts its
own.  Nothing is built when the module is imported.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda


def loop_cond_plain(done: torch.Tensor, rounds: torch.Tensor,
                    max_rounds: int) -> torch.Tensor:
    """``knn_loop_cond``'s plain version: ``rounds`` (a (1,) int32) plus
    one, in place; returns the (1,) int32 flag, 1 while some query is
    not ``done`` and ``rounds < max_rounds``."""
    rounds += 1
    return ((~done.all()) & (rounds < max_rounds)).to(torch.int32)


def _check(done, rounds, flag) -> None:
    if not (done.is_cuda and done.dtype == torch.bool and done.dim() == 1
            and done.is_contiguous()):
        raise ValueError("done must be a contiguous 1-D bool CUDA tensor")
    for t in (rounds, flag):
        if t.device != done.device or t.dtype != torch.int32 \
                or t.numel() != 1:
            raise ValueError("rounds and flag must be one int32 each, on "
                             "done's device")


class WhileGraph:
    """An instantiated WHILE graph: ``body`` (a PyTorch ``CUDAGraph``
    captured with ``keep_graph=True``, or None for the condition alone)
    then ``knn_loop_cond`` over ``done``, ``rounds`` and ``flag``, again
    while the condition holds.  The body's graph is copied in; its
    memory (PyTorch's private pool) stays the caller's to keep.

    Raises ``RuntimeError`` naming the CUDA error where the driver
    refuses the graph (conditional nodes need CUDA 12.4 or later, and a
    body on one device)."""

    def __init__(self, body, done: torch.Tensor, rounds: torch.Tensor,
                 max_rounds: int, flag: torch.Tensor):
        _check(done, rounds, flag)
        raw = None if body is None else body.raw_cuda_graph()
        graph, exec_ = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(done.device):
            err = _cuda.host("graph_loop_build")(
                raw, done.data_ptr(), done.numel(), rounds.data_ptr(),
                int(max_rounds), flag.data_ptr(), ctypes.addressof(graph),
                ctypes.addressof(exec_))
        if err != 0:
            raise RuntimeError(
                f"the kNN loop's CUDA graph was refused: cudaError {err} "
                f"from graph_loop_build (a WHILE conditional node over the "
                f"captured round; it needs CUDA 12.4 or later and a round "
                f"on one device)")
        self._graph, self._exec = graph.value, exec_.value
        self.device = done.device

    def launch(self) -> None:
        """Run the loop on the device's current stream (no host sync)."""
        index = self.device.index
        if index is None:
            index = torch.cuda.current_device()
        err = _cuda.host("graph_loop_launch")(
            self._exec, _cuda.current_stream(index))
        if err != 0:
            raise RuntimeError(f"the kNN loop's CUDA graph failed to "
                               f"launch: cudaError {err}")

    def close(self) -> None:
        """Destroy the graph (idempotent)."""
        graph, exec_ = self._graph, self._exec
        self._graph = self._exec = None
        if graph is not None or exec_ is not None:
            _cuda.host("graph_loop_destroy")(graph, exec_)

    def __del__(self):
        try:
            self.close()
        except Exception:       # interpreter shutdown: CUDA may be gone
            pass


def loop_rounds(done: torch.Tensor, max_rounds: int):
    """The condition alone in a WHILE graph, once: returns (rounds,
    flag) as (1,) int32 tensors on ``done``'s device.  ``rounds`` ends
    at ``max_rounds`` where some query is open, at 1 where none is (the
    first round always runs), as :func:`loop_cond_plain` run in a loop
    gives; one ``knn_loop_cond`` launch is counted per round."""
    rounds = torch.zeros(1, dtype=torch.int32, device=done.device)
    flag = torch.zeros_like(rounds)
    graph = WhileGraph(None, done, rounds, max_rounds, flag)
    graph.launch()
    ran = int(rounds.item())
    graph.close()
    _cuda.add_launches({"knn_loop_cond": 1}, ran)
    return rounds, flag


def loop_rounds_plain(done: torch.Tensor, max_rounds: int):
    """:func:`loop_rounds`' plain version."""
    rounds = torch.zeros(1, dtype=torch.int32, device=done.device)
    while True:
        flag = loop_cond_plain(done, rounds, max_rounds)
        if not bool(flag):
            return rounds, flag


__all__ = ["WhileGraph", "loop_cond_plain", "loop_rounds",
           "loop_rounds_plain"]
