"""One DMC step and its estimators, in plain PyTorch.

The step (``samplers/dmc.py`` of the program gives the same sequence):

1. comb on the stored weights: walker ``i`` of the ``n`` valid ones is
   cloned ``floor(w_i + u_i)`` times, the first ``Wm`` children kept;
2. the children are their parents' positions, drifts and energies;
3. the controller: ``E_accum = (E_tot + sum E) / (W_tot + n)``,
   ``E_ref = E_accum - c log(n / n_target) / dt``;
4. the children move: ``z' = z + 2 F dt + sqrt(2 dt) xi``, wrapped into
   ``[0, L)``, ``xi`` the Philox normals of ``(seed, global step)``;
5. the local energy and drift at ``z'``, and the weight
   ``exp(-dt ((E' + E) / 2 - E_ref_before))``.

The estimators measure the children before they move.  A pure
(forward-walking) estimator adds each walker's values to an accumulator
that follows the walker's ancestry; its row is the accumulators' sum over
the valid walkers divided by the number of measurements so far.

The comb's decision ``floor(w + u)`` is taken in the dtype the weights
are stored in (the control takes it in its own), so that a decision
never turns on the reference's own rounding; everything else runs in
``dtype``.
"""
import math

import torch

from . import philox, streams

__all__ = ["estimate", "step", "weights"]


def step(model, proc: dict, state: dict, seed: int, block_index: int,
         step_in_block: int, steps_per_block: int, dtype, device,
         comb_dtype=None) -> dict:
    """The step from ``state`` (tensors by the program's field names).
    The comb adds the weights and uniforms in ``comb_dtype``, by default
    the weights' own."""
    slots = state["weights"].shape[0]
    nop = state["pos"].shape[1]
    dt = float(proc["time_step"])
    u = streams.dmc_comb_uniforms(seed, block_index, step_in_block, slots,
                                  state["weights"].dtype, device)
    comb_dtype = comb_dtype or state["weights"].dtype
    ids = torch.arange(slots, device=device)
    n_in = int(state["num_walkers"])
    clones = torch.floor(state["weights"].to(device, comb_dtype)
                         + u.to(comb_dtype)).long()
    clones = torch.where(ids < n_in, clones, 0)
    cum = torch.cumsum(clones, 0)
    nw = min(int(cum[-1]), slots)
    parent = torch.clamp(torch.searchsorted(cum, ids, right=True), 0,
                         slots - 1)
    valid = ids < nw

    def take(name):
        return state[name].to(device=device, dtype=dtype)[parent]

    cpos, cdrift, cenergy = take("pos"), take("drift"), take("energies")
    energy = torch.where(valid, cenergy, 0.0).sum()
    total_energy = state["total_energy"].to(device, dtype) + energy
    total_weight = state["total_weight"].to(device, dtype) + nw
    accum = total_energy / total_weight
    ref = accum - float(proc["num_walkers_control_factor"]) * math.log(
        max(nw, 1) / float(proc["target_num_walkers"])) / dt
    xi = math.sqrt(2 * dt) * philox.normals(
        seed, block_index * steps_per_block + step_in_block, (slots, nop),
        dtype, device)
    shift = 2.0 * cdrift * dt + xi
    out = dict(parent=parent, valid=valid, num_walkers=nw, cpos=cpos,
               cenergy=cenergy, pos=torch.remainder(cpos + shift,
                                                    model.p.length),
               energy=energy, weight=float(nw), total_energy=total_energy,
               total_weight=total_weight, accum_energy=accum,
               ref_energy=ref)
    if state.get("cmd_accum") is not None:
        out["cmd_accum"] = take("cmd_accum") + shift.mean(-1)
    return out


def weights(new_energies, cenergy, ref_before, valid, dt: float):
    """The branching weights of the moved children."""
    w = torch.exp(-dt * (0.5 * (new_energies + cenergy) - ref_before))
    return torch.where(valid, w, 0.0)


def _every(traffic_proc: dict, spec: dict) -> int:
    return int(traffic_proc.get("est_every", 1)) * int(
        spec.get("est_every_mult", 1))


def estimate(model, traffic_proc: dict, est: dict, ref_step: dict,
             dtype, device) -> dict:
    """The rows of one measured step: ``est`` holds the program's state
    that the step hands its estimators (the pure accumulators ``aux``,
    the composed ancestry ``perm`` and ``itc_perm``, the ITC ring buffer
    and fill, the step's index in the window) and ``ref_step`` the
    reference's own step (its parents, valid slots, children and CM
    accumulator).  Returns ``(rows, itc_buf, itc_filled)``."""
    step_idx = int(est["step_idx"])
    valid = ref_step["valid"]
    cpos = ref_step["cpos"]
    parent = ref_step["parent"]
    perm = est.get("perm")
    anc = parent if perm is None else perm.to(device)[parent]
    rows = {}

    def masked_sum(x):
        mask = valid.view(valid.shape + (1,) * (x.dim() - 1))
        return torch.where(mask, x, 0.0).sum(0)

    def measure(key, name, spec, values):
        if not spec.get("as_pure_est"):
            rows[name] = masked_sum(values)
            return
        every = _every(traffic_proc, spec)
        pfw = int(spec.get("pfw_num_time_steps") or
                  traffic_proc["num_time_steps_block"])
        acc = est["aux"][key].to(device=device, dtype=dtype)[anc]
        if step_idx < pfw:
            acc = acc + values
        divisor = min((step_idx + 1) // every, pfw // every)
        rows[name] = masked_sum(acc) / divisor

    def due(spec):
        return (step_idx + 1) % _every(traffic_proc, spec) == 0

    spec = traffic_proc.get("density_spec")
    if spec is not None:
        hist = model.density_hist(cpos, int(spec["num_bins"]))
        measure("aux_density", "density", spec,
                torch.where(valid[:, None], hist, 0.0))
    spec = traffic_proc.get("ssf_spec")
    if spec is not None:
        measure("aux_ssf", "ssf", spec,
                model.ssf_parts(cpos, int(spec["num_modes"])))
    spec = traffic_proc.get("obd_spec")
    if spec is not None and due(spec):
        measure("aux_obd", "obd", spec,
                model.obd_grid(cpos, int(spec["num_pos"])))
    spec = traffic_proc.get("pair_corr_spec")
    if spec is not None and due(spec):
        measure("aux_g2", "g2", spec,
                model.pair_hist(cpos, int(spec["num_bins"])))
    if ref_step.get("cmd_accum") is not None:
        cmd = ref_step["cmd_accum"]
        rows["cmd"] = torch.stack([masked_sum(cmd ** 2), masked_sum(cmd)])
    itc_buf = itc_filled = None
    spec = traffic_proc.get("itc_spec")
    if spec is not None and due(spec):
        rows_itc, itc_buf, itc_filled = _itc(model, traffic_proc, spec, est,
                                             ref_step, step_idx, dtype,
                                             device, masked_sum)
        rows.update(rows_itc)
    return rows, itc_buf, itc_filled


def _itc(model, traffic_proc, spec, est, ref_step, step_idx, dtype, device,
         masked_sum):
    """The imaginary-time correlation's rows: the products of this
    step's ``rho_k`` with each lag row of the ring buffer, and the buffer
    shifted by one row with the new amplitudes in front."""
    num_lags, num_modes = int(spec["num_lags"]), int(spec["num_modes"])
    valid = ref_step["valid"]
    itc_perm = est["itc_perm"].to(device)
    buf = est["itc_buf"].to(device=device, dtype=dtype)[itc_perm]
    filled = int(est["itc_filled"])
    reim = model.ssf_reim(ref_step["cpos"], num_modes)
    re, im = reim[..., 0], reim[..., 1]
    maskf = valid.to(dtype)
    lag_ok = (torch.arange(1, num_lags + 1, device=device) <= filled).to(
        dtype)
    prod = (buf[..., 0] * re[:, None] + buf[..., 1] * im[:, None]) \
        * maskf[:, None, None]
    rows = {}
    if spec.get("as_pure_est"):
        every = _every(traffic_proc, spec)
        pfw = int(spec.get("pfw_num_time_steps") or
                  traffic_proc["num_time_steps_block"])
        sq = torch.where(valid[:, None], re ** 2 + im ** 2, 0.0)
        contrib = torch.cat([sq[:, None], prod], dim=1)
        cnt_row = torch.cat([lag_ok.new_ones(1), lag_ok])
        acc = est["aux"]["aux_itc"].to(device=device, dtype=dtype)[itc_perm]
        cnt = est["aux"]["aux_itc_cnt"].to(device=device,
                                           dtype=dtype)[itc_perm]
        if step_idx < pfw:
            acc = acc + contrib
            cnt = cnt + maskf[:, None] * cnt_row
        divisor = min((step_idx + 1) // every, pfw // every)
        rows["itc"] = masked_sum(acc) / divisor
        rows["itc_nw"] = masked_sum(cnt) / divisor
    else:
        lag0 = masked_sum(re ** 2 + im ** 2)
        rows["itc"] = torch.cat([lag0[None], prod.sum(0)])
        nwf = float(ref_step["num_walkers"])
        rows["itc_nw"] = torch.cat([torch.tensor([nwf], dtype=dtype,
                                                 device=device),
                                    nwf * lag_ok])
    new_buf = torch.cat([reim[:, None], buf[:, :-1]], dim=1)
    return rows, new_buf, min(filled + 1, num_lags)
