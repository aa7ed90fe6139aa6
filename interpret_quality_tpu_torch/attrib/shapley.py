"""Region-Shapley estimation engine (counterpart of
``interpret_quality_tpu/attrib/shapley.py``).

Each step masks one cloud into a chunk of permutations' coalitions
(``batch_orders`` orders x (R+1) rows), runs the frozen model's eval forward
on the whole chunk, takes the reward, and scatters the marginals by region
on the device.  Chunks and poses are a plain Python loop; results reach the
host once per call.

Every public method runs its stages inside profiler spans, beside the
forward's ``iq_forward`` and the plan's ``iq_plan``: ``iq_engine.keep``
(the call's inputs and each chunk's keep matrix and orders, built on the
host and uploaded), ``iq_engine.mask`` (each masked batch, and each pose of
it), ``iq_engine.marginals`` (the reward and the marginals of each forward,
summed over its orders) and ``iq_engine.to_host`` (the results gathered and
copied to the host).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..ops.precision import matmul
from .coalitions import (keep_matrix_from_orders, marginals_by_region,
                         masked_coalitions)
from .reward import reward_from_logits


def region_id_from_fps(data: torch.Tensor, fps_index: torch.Tensor) -> torch.Tensor:
    """Assign each point of ``data`` (N, 3) to its nearest FPS centre
    (reference final_shapley_value.py:20-35): (N,) int32, ties to the lowest
    centre index.  The product follows the matmul precision, as the JAX
    function's, so at ``default`` ids may differ from ``highest``'s."""
    centers = data[fps_index.long()]                         # (R, 3)
    d2 = (torch.sum(data * data, -1, keepdim=True)
          - 2.0 * matmul(data, centers.T)
          + torch.sum(centers * centers, -1)[None, :])       # (N, R)
    return torch.argmin(d2, dim=-1).to(torch.int32)


def generate_all_orders(num_samples_save: int, num_regions: int,
                        rng: Optional[np.random.RandomState] = None,
                        antithetic: bool = False) -> np.ndarray:
    """Random permutations, host-side numpy (reference
    final_shapley_value.py:59-72), drawn from the global numpy stream when
    ``rng`` is None, so ``utils.rng.set_random`` reproduces the JAX package's
    permutations bit for bit.  ``antithetic`` draws (pi, reverse pi) pairs."""
    r = rng if rng is not None else np.random
    if antithetic:
        num_pairs = (num_samples_save + 1) // 2
        orders = []
        for _ in range(num_pairs):
            pi = r.permutation(np.arange(num_regions))
            orders.append(pi.reshape(1, -1))
            orders.append(pi[::-1].reshape(1, -1))
        return np.concatenate(orders, axis=0)[:num_samples_save]
    orders = [r.permutation(np.arange(num_regions)).reshape(1, -1)
              for _ in range(num_samples_save)]
    return np.concatenate(orders, axis=0)


class ShapleyEngine:
    """Batched masked-coalition Shapley estimator for one frozen model.

    Args:
      forward_fn: ``(B, N, 3) -> (B, num_class)`` logits on ``device``:
        the model's ``ForwardFn``, or its split over devices
        (``parallel.SplitForward``, logits on its first device).
      num_regions: R.
      softmax_type: reward type ("modified" | "normal").
      batch_orders: permutations per forward (the forward batch is
        ``batch_orders * (R+1)`` clouds).
      device: where the clouds, masks and marginals live.
    """

    def __init__(self, forward_fn: Callable, num_regions: int,
                 softmax_type: str = "modified", batch_orders: int = 100,
                 device="cuda"):
        self.forward_fn = forward_fn
        self.num_regions = num_regions
        self.softmax_type = softmax_type
        self.batch_orders = batch_orders
        self.device = torch.device(device)

    # ------------------------------------------------------------- helpers
    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x))         # a copy: inputs may be read-only
        return x.to(device=self.device, dtype=dtype)

    def _inputs(self, *arrays):
        """The call's cloud(s) as float32 and region ids as int64 on the
        device (``iq_engine.keep``); ``arrays`` are (value, dtype) pairs."""
        with record_function("iq_engine.keep"):
            return [self._tensor(x, dtype) for x, dtype in arrays]

    def _chunks(self, orders: np.ndarray):
        """(keep (O, R+1, R) bool, orders (O, R) int64) per order chunk."""
        bs = min(self.batch_orders, orders.shape[0])
        for start in range(0, orders.shape[0], bs):
            with record_function("iq_engine.keep"):
                chunk = orders[start:start + bs]
                item = (self._tensor(keep_matrix_from_orders(chunk), torch.bool),
                        self._tensor(chunk, torch.int64))
            yield item

    def _marginals(self, logits: torch.Tensor, orders: torch.Tensor, label):
        """(O, R) per-order marginals by region of one chunk's logits."""
        v = reward_from_logits(logits, label, self.softmax_type)
        v = v.reshape(orders.shape[0], self.num_regions + 1)
        return marginals_by_region(v[:, 1:] - v[:, :-1], orders)

    def _add_marginals(self, total, logits, orders, label):
        """(total + the chunk's marginals summed over its orders, the
        per-order marginals (O, R)); total None starts the sum."""
        with record_function("iq_engine.marginals"):
            dv = self._marginals(logits, orders, label)
            sv = dv.sum(dim=0)
            return (sv if total is None else total + sv), dv

    def _step(self, data, keep, region_id):
        """One chunk's masked batch of one cloud, forwarded: its logits."""
        with record_function("iq_engine.mask"):
            masked = masked_coalitions(data, data.mean(dim=0), keep, region_id)
        return self.forward_fn(masked)

    # -------------------------------------------------------------- public
    @torch.inference_mode()
    def shapley_for_pose(self, data, label, region_id, orders,
                         return_logits: bool = False,
                         return_per_order: bool = False):
        """Shapley values of all regions for one (possibly disturbed) cloud.

        Args:
          data: (N, 3) array or tensor; label: int; region_id: (N,) ints;
          orders: (S, R) permutations to average over.
        Returns:
          region_shap_value (R,) float64 numpy — the mean marginal per
          region — plus, optionally, the raw logits (S*(R+1), C) and the
          per-order contributions (S, R), in the reference's row layout.
        """
        orders = np.asarray(orders)
        data, region_id = self._inputs((data, torch.float32),
                                       (region_id, torch.int64))
        sv_sum = None
        logits_chunks: List[torch.Tensor] = []
        per_order_chunks: List[torch.Tensor] = []
        for keep, chunk in self._chunks(orders):
            logits = self._step(data, keep, region_id)
            sv_sum, dv = self._add_marginals(sv_sum, logits, chunk, label)
            logits_chunks.append(logits)
            per_order_chunks.append(dv)
        with record_function("iq_engine.to_host"):
            out = [sv_sum.cpu().numpy().astype(np.float64) / orders.shape[0]]
            if return_logits:
                out.append(torch.cat(logits_chunks, 0).cpu().numpy())
            if return_per_order:
                out.append(torch.cat(per_order_chunks, 0).cpu().numpy())
        return tuple(out) if len(out) > 1 else out[0]

    @torch.inference_mode()
    def shapley_for_poses(self, data_batch, label, region_id, orders,
                          return_logits: bool = True):
        """``shapley_for_pose`` for each cloud of a (P, N, 3) batch of poses.

        Returns (P, R) float64 numpy and, optionally, logits (P, S*(R+1), C).
        """
        poses, = self._inputs((data_batch, torch.float32))
        results = [self.shapley_for_pose(d, label, region_id, orders,
                                         return_logits=return_logits)
                   for d in poses]
        with record_function("iq_engine.to_host"):
            if not return_logits:
                return np.stack(results)
            return (np.stack([sv for sv, _ in results]),
                    np.stack([lg for _, lg in results]))

    @torch.inference_mode()
    def enum_all_poses(self, disturb_fn: Callable, data, all_params, label,
                       region_id, orders, return_logits: bool = True):
        """Shapley values at every pose of a grid, the graph rebuilt inside
        every forward.

        Args:
          disturb_fn: ``(cloud (..., N, 3), param) -> (..., N, 3)``.
          all_params: (P, ...) pose parameters.
        Returns:
          (region_shap_value (P, R) float64 numpy,
           logits (P, S*(R+1), C) numpy or None).
        """
        orders = np.asarray(orders)
        data, region_id, params = self._inputs(
            (data, torch.float32), (region_id, torch.int64),
            (all_params, torch.float32))
        chunks = list(self._chunks(orders))
        sv_sums, logits_poses = [], []
        for param in params:
            with record_function("iq_engine.mask"):
                posed = disturb_fn(data, param)
            sv_sum, logits_chunks = None, []
            for keep, chunk in chunks:
                logits = self._step(posed, keep, region_id)
                sv_sum, _ = self._add_marginals(sv_sum, logits, chunk, label)
                if return_logits:
                    logits_chunks.append(logits)
            sv_sums.append(sv_sum)
            logits_poses.append(logits_chunks)
        return self._enum_result(sv_sums, orders.shape[0], logits_poses,
                                 return_logits)

    @torch.inference_mode()
    def enum_all_poses_plan(self, disturb_fn: Callable, data, all_params,
                            label, region_id, orders, plan_fn: Callable,
                            apply_plan: Callable, return_logits: bool = True):
        """``enum_all_poses`` with pose-invariant graph reuse: per order
        chunk, mask the canonical cloud once and build the model's graph
        plan once (models/plans.py), then forward every pose of the masked
        batch with that plan.  Same return contract."""
        orders = np.asarray(orders)
        data, region_id, params = self._inputs(
            (data, torch.float32), (region_id, torch.int64),
            (all_params, torch.float32))
        P = params.shape[0]
        sv_sum: List[Optional[torch.Tensor]] = [None] * P
        logits_poses: List[List[torch.Tensor]] = [[] for _ in range(P)]
        for keep, chunk in self._chunks(orders):
            with record_function("iq_engine.mask"):
                masked = masked_coalitions(data, data.mean(dim=0), keep,
                                           region_id)
            plan = plan_fn(masked)                      # once per order chunk
            for p in range(P):
                with record_function("iq_engine.mask"):
                    posed = disturb_fn(masked, params[p])
                logits = apply_plan(posed, plan)
                sv_sum[p], _ = self._add_marginals(sv_sum[p], logits, chunk,
                                                   label)
                if return_logits:
                    logits_poses[p].append(logits)
        return self._enum_result(sv_sum, orders.shape[0], logits_poses,
                                 return_logits)

    @staticmethod
    def _enum_result(sv_sums, num_orders, logits_poses, return_logits):
        """(P, R) float64 Shapley values from each pose's marginal sums
        over ``num_orders`` orders and, with ``return_logits``, the poses'
        logits (P, S*(R+1), C), from each pose's list of chunk logits."""
        with record_function("iq_engine.to_host"):
            sv = (torch.stack(sv_sums) / num_orders).cpu().numpy().astype(
                np.float64)
            if not return_logits:
                return sv, None
            return sv, torch.stack([torch.cat(lg, 0) for lg in logits_poses]
                                   ).cpu().numpy()


@torch.inference_mode()
def norm_factor(forward_fn: Callable, data, label,
                softmax_type: str = "modified", device="cuda") -> float:
    """v(N) - v(empty): the reward of the full cloud minus that of the cloud
    collapsed to its centre (reference final_shapley_value.py:39-56)."""
    data = torch.tensor(np.asarray(data), dtype=torch.float32).to(device)
    empty = data.mean(dim=0).expand_as(data)
    v = reward_from_logits(forward_fn(torch.stack([data, empty])), label,
                           softmax_type)
    return float(v[0] - v[1])
