"""TwoAdicFriPcs — the polynomial commitment scheme (twin of
`tapstark.fri.pcs`; reference fri/src/two_adic_pcs.rs).

- commit: per-matrix coset LDE with shift = generator / domain.shift, rows
  bit-reversed, committed by TapTreeMmcs from the LDE tensors (trees hash
  where they live);
- open: batch quotient reduction sum_i alpha^i (p_i(X) - y_i) / (X - z)
  with barycentric ys, alpha-power offsets and precomputed inverse
  denominators, one reduced polynomial per height, then FRI;
- verify: per-query reduced-opening reconstruction + FRI verification
  (exact host arithmetic);
- generate_verify_expr: the Bitcoin-Script FRI/PCS verifier segments,
  emitted while the openings are verified natively (host code).

The LDEs and the reduction run on `device` (int32 Montgomery tensors).
With a mesh (`tapstark_torch.mesh.Mesh`, whose primary device is
`device`), each commit's LDE of at least 2^max(2·log num, 2) rows runs
over the mesh (`distributed_coset_lde`) and lands on `device`, where the
commit, the quotient, the open and FRI run as on one device: the proof's
bytes are one device's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..challenger import BfChallenger
from ..commit.mmcs import TapTreeMmcs
from ..commit.tcs import FMatrix
from ..field.constants import P
from ..field.scalar import EF4, F
from ..utils import log2_strict, reverse_bits_len
from ..field.device import (
    ef_add,
    ef_const,
    ef_inv,
    ef_mul,
    ef_mul_base,
    ef_neg,
    ef_sub,
    fetch_canonical,
    fp_add,
    np_to_mont,
)
from ..poly.domain import TwoAdicMultiplicativeCoset
from ..mesh import normalize_device
from ..mesh.ntt import distributed_coset_lde
from ..poly.interpolate import _interp_weights
from ..poly.ntt import bit_reverse_cols, bit_reverse_rows, coset_lde_batch_auto
from ..poly.powers import bitrev_1d_dev, geom_powers_mont_dev
from ..poly.reduce import fp_sum_axis0
from . import prover as fri_prover
from . import verifier as fri_verifier
from .config import FriConfig
from .proof import FriProof

# columns per reduction step of the open: bounds the (rows, cols, 4) int64
# temporaries of wide matrices (the reference's col_chunk)
_COL_CHUNK = 64

# Script-verifier spill thresholds (see generate_verify_expr.open_input):
# a segment's witness must leave execution headroom under Bitcoin's
# 1000-element stack, so a query script gets ~700 witness limbs and wide
# reduced-opening groups spill into chained sub-scripts of <=120 columns
# (5 limbs each: EF4 p_at_z + base p_at_x) plus boundary accumulators.
_STACK_BUDGET = 700
_SPILL_COLS = 120


@dataclass
class BatchOpening:
    opened_values: list[list[F]]  # per matrix: base-field row scalars
    opening_proof: Any  # CommitedProof


@dataclass
class PcsProverData:
    domains: list[TwoAdicMultiplicativeCoset]
    ldes: list[torch.Tensor]  # (N, w) Montgomery, bit-reversed rows
    commited: Any  # TapTreeMmcs prover data (list[CommitedData])


def _inv_denoms(xs: torch.Tensor, z_mont: torch.Tensor) -> torch.Tensor:
    """(x - z)^{-1} for every x of xs, as (n, 4) Montgomery."""
    denom = ef_neg(z_mont.expand(xs.shape[0], 4))
    denom[:, 0] = fp_add(denom[:, 0], xs)
    return ef_inv(denom)


def _open_height(natural, mat, weights, zs, scales, xs, invd):
    """Open ONE height: every (matrix, point) pair at this height.

    natural: (n, W) natural-order low rows (concat of this height's mats);
    mat:     (h, W) bit-reversed LDE rows (same concat);
    weights: (P, W, 4) alpha powers, zero where a column is not opened at
             that point (the per-entry alpha offset and the column mask);
    zs/scales: (P, 4) per-point barycentric constants;
    xs:      (n,) coset points;  invd: (P, h, 4) inverse denominators.
    Returns (ys (P, W, 4) opened values, ro (h, 4) reduced opening)."""
    h, w = mat.shape
    ys_out = []
    ro = torch.zeros((h, 4), dtype=torch.int32, device=mat.device)
    for p in range(zs.shape[0]):
        iw = _interp_weights(xs, zs[p])  # (n, 4)
        ys = torch.cat(
            [
                fp_sum_axis0(ef_mul_base(iw[:, None, :], natural[:, c0 : c0 + _COL_CHUNK]))
                for c0 in range(0, w, _COL_CHUNK)
            ]
        )
        ys = ef_mul(ys, scales[p])  # (W, 4)
        ys_out.append(ys)
        red_row = torch.zeros((h, 4), dtype=torch.int32, device=mat.device)
        for c0 in range(0, w, _COL_CHUNK):
            prod = ef_mul_base(
                weights[p, None, c0 : c0 + _COL_CHUNK, :], mat[:, c0 : c0 + _COL_CHUNK]
            )  # (h, wc, 4)
            red_row = ef_add(red_row, fp_sum_axis0(prod.transpose(0, 1)))
        ys_dot = fp_sum_axis0(ef_mul(ys, weights[p]))  # (4,)
        ro = ef_add(ro, ef_mul(ef_sub(red_row, ys_dot), invd[p]))
    return torch.stack(ys_out), ro


class TwoAdicFriPcs:
    def __init__(self, mmcs: TapTreeMmcs, fri: FriConfig, device, device_chain: bool = True, mesh=None):
        self.mmcs = mmcs  # base-field input mmcs
        self.fri = fri
        self.device = torch.device(device)
        # False: every FRI layer's beta is sampled on the host (the same
        # bytes; fri/prover.py, the device transcript chain)
        self.device_chain = device_chain
        # the LDEs' mesh (tapstark/fri/pcs.py:138-157); its primary device is `device`
        self.mesh = mesh
        if mesh is not None and mesh.primary != normalize_device(device):
            raise ValueError(f"TwoAdicFriPcs: the mesh's primary device {mesh.primary} is not the PCS's {device}")

    def _lde(self, evals: torch.Tensor, shift: int) -> torch.Tensor:
        mesh = self.mesh
        if mesh is not None and evals.shape[0] >= 1 << max(2 * mesh.log_size, 2):
            return distributed_coset_lde(mesh, evals, self.fri.log_blowup, shift)
        return coset_lde_batch_auto(evals, self.fri.log_blowup, shift)

    def natural_domain_for_degree(self, degree: int) -> TwoAdicMultiplicativeCoset:
        return TwoAdicMultiplicativeCoset(log_n=log2_strict(degree), shift=1)

    # -- commit ------------------------------------------------------------
    def commit(self, evaluations):
        """evaluations: list of (domain, (n, w) Montgomery tensor)."""
        domains, ldes, mats = [], [], []
        for domain, evals in evaluations:
            if domain.size() != evals.shape[0]:
                raise ValueError("domain size and evaluation height differ")
            shift = (F.generator() * F(domain.shift).inverse()).v
            lde = self._lde(evals.contiguous(), shift)
            lde = bit_reverse_rows(lde)
            domains.append(domain)
            ldes.append(lde)
            mats.append(FMatrix(dev=lde))
        commitment, commited = self.mmcs.commit(mats)
        return commitment, PcsProverData(domains=domains, ldes=ldes, commited=commited)

    def get_evaluations_on_domain(self, prover_data: PcsProverData, idx: int, domain):
        """The matrix's (m, w) values on `domain` in natural order: the first
        m rows of its bit-reversed LDE, bit-reversed. On the card the one
        gather writes them by columns (`bit_reverse_cols`: a (w, m) tensor,
        returned as its (m, w) transpose with strides (1, m)), the layout
        the quotient kernels read; on the CPU, by rows."""
        if domain.shift != F.generator().v:
            raise ValueError("expected the disjoint (generator-shifted) domain")
        lde = prover_data.ldes[idx]
        if lde.device.type == "cuda":
            return bit_reverse_cols(lde, domain.size())
        return bit_reverse_rows(lde[: domain.size()])

    # -- open --------------------------------------------------------------
    def open(self, rounds, challenger: BfChallenger):
        """rounds: list of (PcsProverData, points-per-matrix list[list[EF4]]).
        Returns (opened_values[round][matrix][point] -> list[EF4], FriProof)."""
        alpha: EF4 = challenger.sample()
        dev = self.device

        mats_and_points = [(data.ldes, points) for data, points in rounds]
        all_heights = [m.shape[0] for mats, _ in mats_and_points for m in mats]
        log_global_max_height = log2_strict(max(all_heights))

        inv_denoms = self._compute_inverse_denominators(mats_and_points)

        # Group every (round, matrix, point) entry by height. Entries keep
        # the global iteration order, so the per-height alpha-power offsets
        # match the verifier's replay (two_adic_pcs.rs:260-419).
        entries = []  # (round_i, mat_i, point_i, mat, point)
        for ri, (mats, points) in enumerate(mats_and_points):
            for mi, (mat, points_for_mat) in enumerate(zip(mats, points)):
                for pi, point in enumerate(points_for_mat):
                    entries.append((ri, mi, pi, mat, point))

        heights: dict[int, dict] = {}
        for ri, mi, pi, mat, point in entries:
            lh = log2_strict(int(mat.shape[0]))
            g = heights.setdefault(lh, {"mats": {}, "points": {}, "entries": [], "ncols": 0})
            if (ri, mi) not in g["mats"]:
                g["mats"][(ri, mi)] = (g["ncols"], mat)
                g["ncols"] += int(mat.shape[1])
            if point not in g["points"]:
                g["points"][point] = len(g["points"])
            g["entries"].append((ri, mi, pi, point))

        # alpha powers: one host table long enough for any height
        max_pows = max(
            sum(int(e[3].shape[1]) for e in entries if log2_strict(int(e[3].shape[0])) == lh)
            for lh in heights
        )
        alpha_pows = []
        ap = EF4.one()
        for _ in range(max_pows):
            alpha_pows.append(ap)
            ap = ap * alpha

        reduced_openings: dict[int, torch.Tensor] = {}
        ys_slices: dict[tuple[int, int, int], torch.Tensor] = {}
        shift = F.generator().v
        for lh, g in sorted(heights.items(), reverse=True):
            n_low = (1 << lh) >> self.fri.log_blowup
            n_pts = len(g["points"])
            mats_ordered = [m for (_, m) in sorted(g["mats"].values(), key=lambda t: t[0])]
            cat = mats_ordered[0] if len(mats_ordered) == 1 else torch.cat(mats_ordered, dim=1)
            natural = bit_reverse_rows(cat[:n_low])

            # per-point alpha-weight matrix: entry k (matrix cols [c0, c0+w)
            # opened at point p) gets alpha^{o_k} .. alpha^{o_k+w-1}
            weights_np = np.zeros((n_pts, g["ncols"], 4), np.uint32)
            num_reduced = 0
            for ri, mi, pi, point in g["entries"]:
                c0, mat = g["mats"][(ri, mi)]
                w = int(mat.shape[1])
                p_idx = g["points"][point]
                for j in range(w):
                    weights_np[p_idx, c0 + j] = alpha_pows[num_reduced + j].as_u32_vec()
                num_reduced += w

            zs_np = np.empty((n_pts, 4), np.uint32)
            scales_np = np.empty((n_pts, 4), np.uint32)
            s_pow_n = pow(shift, n_low, P)
            for point, p_idx in g["points"].items():
                zs_np[p_idx] = point.as_u32_vec()
                scale = (point.exp(n_low) - EF4((s_pow_n, 0, 0, 0))) * EF4(
                    ((n_low % P) * s_pow_n % P, 0, 0, 0)
                ).inverse()
                scales_np[p_idx] = scale.as_u32_vec()
            log_low = log2_strict(n_low)
            xs = geom_powers_mont_dev(F.two_adic_generator(log_low).v, log_low, shift, dev)
            points_in_order = sorted(g["points"].items(), key=lambda kv: kv[1])
            invd = torch.stack([inv_denoms[point][: 1 << lh] for point, _ in points_in_order])

            ys_all, ro = _open_height(
                natural, cat, _mont_tensor(weights_np, dev), _mont_tensor(zs_np, dev),
                _mont_tensor(scales_np, dev), xs, invd,
            )
            reduced_openings[lh] = ro
            for ri, mi, pi, point in g["entries"]:
                c0, mat = g["mats"][(ri, mi)]
                ys_slices[(ri, mi, pi)] = ys_all[g["points"][point], c0 : c0 + int(mat.shape[1])]

        all_opened_values = [
            [
                [_ef_list(ys_slices[(ri, mi, pi)]) for pi in range(len(points_for_mat))]
                for mi, (_, points_for_mat) in enumerate(zip(mats, points))
            ]
            for ri, (mats, points) in enumerate(mats_and_points)
        ]

        fri_input = [reduced_openings[lh] for lh in sorted(reduced_openings, reverse=True)]

        def reduced_index(data, query_index):
            log_max_height = log2_strict(self.mmcs.get_max_height(data.commited))
            return query_index >> (log_global_max_height - log_max_height)

        def open_input(query_times_index, query_index):
            out = []
            for data, _ in rounds:
                opened_values, opening_proof = self.mmcs.open_batch(
                    query_times_index, reduced_index(data, query_index), data.commited
                )
                out.append(BatchOpening(opened_values=opened_values, opening_proof=opening_proof))
            return out

        def plan_input(query_times_index, query_index):
            # the input rounds' gathers of this query, copied with the
            # layers' in one copy by the FRI prover
            return [
                p
                for data, _ in rounds
                for p in data.commited[query_times_index].plan_query(reduced_index(data, query_index))
            ]

        fri_proof = fri_prover.bf_prove(
            self.fri, fri_input, challenger, open_input, plan_input=plan_input, device_chain=self.device_chain
        )
        return all_opened_values, fri_proof

    def _compute_inverse_denominators(self, mats_and_points):
        """Per unique opening point z: (2^max_log_height, 4) tensor of
        (x - z)^{-1} over the bit-reversed generator coset (prefix-sliceable,
        two_adic_pcs.rs:677-720)."""
        max_log_height_for_point: dict[EF4, int] = {}
        for mats, points in mats_and_points:
            for mat, points_for_mat in zip(mats, points):
                log_height = log2_strict(int(mat.shape[0]))
                for z in points_for_mat:
                    prev = max_log_height_for_point.get(z, 0)
                    max_log_height_for_point[z] = max(prev, log_height)

        max_log = max(max_log_height_for_point.values())
        g = F.two_adic_generator(max_log).v
        xs = bitrev_1d_dev(geom_powers_mont_dev(g, max_log, F.generator().v, self.device), max_log)
        return {
            z: _inv_denoms(xs[: 1 << lh], ef_const(z, self.device))
            for z, lh in max_log_height_for_point.items()
        }

    # -- verify ------------------------------------------------------------
    def verify(self, rounds, proof: FriProof, challenger: BfChallenger) -> None:
        """rounds: list of (commitment, list of (domain, list of (z, ys)))."""
        alpha: EF4 = challenger.sample()
        log_global_max_height = (
            len(proof.commit_phase_commits) + self.fri.log_blowup + self.fri.log_final_poly_len
        )
        fri_challenges = fri_verifier.verify_shape_and_sample_challenges(
            self.fri, proof, challenger
        )

        def open_input(query_times_index, index, input_proof):
            reduced_openings: dict[int, list] = {}
            for batch_opening, (batch_commit, mats) in zip(input_proof, rounds):
                if not self.mmcs.verify_batch(
                    query_times_index,
                    batch_opening.opened_values,
                    batch_opening.opening_proof,
                    batch_commit,
                ):
                    raise fri_verifier.FriError("input batch opening invalid")
                for mat_opening, (mat_domain, mat_points_and_values) in zip(
                    batch_opening.opened_values, mats
                ):
                    log_height = mat_domain.log_n + self.fri.log_blowup
                    bits_reduced = log_global_max_height - log_height
                    rev_reduced_index = reverse_bits_len(index >> bits_reduced, log_height)
                    x = F.generator() * F.two_adic_generator(log_height).exp(rev_reduced_index)
                    state = reduced_openings.setdefault(log_height, [EF4.one(), EF4.zero()])
                    for z, ps_at_z in mat_points_and_values:
                        acc = EF4.zero()
                        for p_at_x, p_at_z in zip(mat_opening, ps_at_z):
                            acc = acc + state[0] * (-p_at_z + p_at_x)
                            state[0] = state[0] * alpha
                        state[1] = state[1] + acc * (-z + x).inverse()
            return [
                (lh, reduced_openings[lh][1])
                for lh in sorted(reduced_openings.keys(), reverse=True)
            ]

        fri_verifier.verify_challenges(self.fri, proof, fri_challenges, open_input)

    # -- script-verifier emission ------------------------------------------
    def generate_verify_expr(self, rounds, proof: FriProof, challenger: BfChallenger):
        """Emit the Bitcoin-Script FRI/PCS verification expressions while
        natively verifying the openings (reference two_adic_pcs.rs:552-675).
        Returns the ManagerAssign with one InputManager per FRI query."""
        from ..dsl.expr import Expr
        from . import script_verifier as fri_script

        alpha: EF4 = challenger.sample()
        log_global_max_height = (
            len(proof.commit_phase_commits)
            + self.fri.log_blowup
            + self.fri.log_final_poly_len
        )

        fri_challenges = fri_script.bf_sample_challenges(self.fri, proof, challenger)

        def open_input(query_times_index, index, input_proof, manager, manager_assign):
            # pass 1: native batch verification + flatten the per-(matrix,
            # point) reduction work in assignment order
            groups = []  # (log_height, x_minus_z, ps_at_z, mat_opening)
            for batch_opening, (batch_commit, mats) in zip(input_proof, rounds):
                if not self.mmcs.verify_batch(
                    query_times_index,
                    batch_opening.opened_values,
                    batch_opening.opening_proof,
                    batch_commit,
                ):
                    raise fri_verifier.FriError("input batch opening invalid")

                for mat_opening, (mat_domain, mat_points_and_values) in zip(
                    batch_opening.opened_values, mats
                ):
                    log_height = mat_domain.log_n + self.fri.log_blowup
                    bits_reduced = log_global_max_height - log_height
                    rev_reduced_index = reverse_bits_len(
                        index >> bits_reduced, log_height
                    )
                    x = F.generator() * F.two_adic_generator(log_height).exp(
                        rev_reduced_index
                    )
                    for z, ps_at_z in mat_points_and_values:
                        groups.append(
                            (log_height, -z + EF4.from_base(x), ps_at_z, mat_opening)
                        )

            # pass 2: emit. A query script's witness must fit Bitcoin's
            # 1000-element stack; wide matrices SPILL their reduced-opening
            # sum into chained sub-scripts ("ro-part:k") whose running EF4
            # accumulators are bit-committed at the boundaries — the main
            # query script consumes one committed group value per spilled
            # group. Small configs keep the round-1 inline emission.
            fold_limbs = 12 * len(proof.commit_phase_commits) + 8
            budget = _STACK_BUDGET - fold_limbs
            alpha_pows: dict[int, EF4] = {}
            ro_exprs: dict[int, Expr] = {}
            ro_natives: dict[int, EF4] = {}
            part = 0

            def _ef(v):
                return v if isinstance(v, EF4) else EF4.from_base(v)

            for log_height, x_minus_z, ps_at_z, mat_opening in groups:
                ap = alpha_pows.setdefault(log_height, EF4.one())
                ro = ro_exprs.setdefault(log_height, Expr.constant(EF4.zero()))
                ro_n = ro_natives.setdefault(log_height, EF4.zero())
                inv_native = x_minus_z.inverse()
                group_limbs = 5 * len(ps_at_z) + 4
                if group_limbs <= budget:
                    budget -= group_limbs
                    # p_at_z is assigned POSITIVELY (the reference assigns
                    # -p_at_z, two_adic_pcs.rs:652): the same opened values
                    # appear positively in the quotient/constraint segments,
                    # so positive assignment dedups their u32 bit commitments
                    # across segments.
                    acc = Expr.constant(EF4.zero())
                    acc_n = EF4.zero()
                    for p_at_x, p_at_z in zip(mat_opening, ps_at_z):
                        acc = acc - Expr.constant(ap) * (
                            manager.assign_input_f(p_at_z)
                            - manager.assign_input_f(p_at_x)
                        )
                        acc_n = acc_n - ap * (_ef(p_at_z) - _ef(p_at_x))
                        ap = ap * alpha
                    # the group's quotient value g = acc/(x-z) is the hint;
                    # verify the multiplied-through form g*(x-z) == acc
                    # (constant-Karatsuba) instead of computing acc*inv
                    # (dynamic Karatsuba) — same hint-commitment count
                    g_native = acc_n * inv_native
                    g_in = manager.assign_hint_input_f(g_native)
                    manager.add_hint_verify(
                        (g_in * Expr.constant(x_minus_z)).equal_verify(acc)
                    )
                    ro_exprs[log_height] = ro + g_in
                    ro_natives[log_height] = ro_n + g_native
                else:
                    budget -= 4  # the committed group value in the main script
                    s_native = EF4.zero()
                    s_expr = None
                    cols = list(zip(mat_opening, ps_at_z))
                    while cols:
                        chunk, cols = cols[:_SPILL_COLS], cols[_SPILL_COLS:]
                        sub = manager_assign.next_manager(
                            f"fri-pcs-verify query_index:{index} ro-part:{part}"
                        )
                        part += 1
                        s_expr = (
                            Expr.constant(EF4.zero())
                            if s_expr is None
                            else sub.assign_input_f(s_native)
                        )
                        for p_at_x, p_at_z in chunk:
                            s_expr = s_expr - Expr.constant(ap) * (
                                sub.assign_input_f(p_at_z)
                                - sub.assign_input_f(p_at_x)
                            )
                            s_native = s_native - ap * (_ef(p_at_z) - _ef(p_at_x))
                            ap = ap * alpha
                        if cols:
                            sub.set_exec_dsl(
                                s_expr.equal_verify(sub.assign_input_f(s_native))
                            )
                        else:
                            # multiplied-through division: commit the group
                            # value g and verify g*(x-z) == s in the last
                            # chunk (no inverse hint, no dynamic Karatsuba)
                            g_native = s_native * inv_native
                            g_out = sub.assign_input_f(g_native)
                            sub.set_exec_dsl(
                                (g_out * Expr.constant(x_minus_z)).equal_verify(
                                    s_expr
                                )
                            )
                            ro_exprs[log_height] = ro + manager.assign_input_f(
                                g_native
                            )
                            ro_natives[log_height] = ro_n + g_native
                alpha_pows[log_height] = ap
            return [
                (lh, ro_exprs[lh], ro_natives[lh])
                for lh in sorted(ro_exprs.keys(), reverse=True)
            ]

        return fri_script.bf_verify_challenges(
            self.fri, proof, fri_challenges, open_input
        )


def _mont_tensor(canonical: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np_to_mont(canonical).astype(np.int32)).to(device)


def _ef_list(ys: torch.Tensor) -> list[EF4]:
    return [EF4([int(x) for x in row]) for row in fetch_canonical(ys)]
