"""Per-photon Monte Carlo of donor-dye relaxation over coupled
protein x dye MSMs (counterpart of ``enspara_tpu/geometry/dye_lifetimes.py``;
reference: enspara/geometry/dye_lifetimes.py).

For each protein conformation, dye MSMs are rebuilt after removing
sterically clashed dye states; the donor excitation then random-walks
through (donor state, acceptor state) pairs, each step evaluating the
instantaneous FRET rate from kappa^2 and distance until it decays
radiatively, non-radiatively, or by energy transfer.

The host treatments (the per-photon walk, static and isotropic dyes, the
bursts) keep the JAX package's numpy streams. The lockstep Monte Carlo
(:func:`resolve_excitations_device`) runs in torch ops on the device of
``device=`` (default: the card) with a ``torch.Generator``: every photon
of every protein conformation steps together, each categorical draw is
one uniform against a precomputed alias table, and the host reads whether
any photon is still excited once a block of steps. It matches the JAX
function in its statistics, not draw for draw.
"""

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy.optimize import curve_fit

from .. import exception, ra
from ..msm import builders, synthetic_data
from ..util.device import resolve_device
from . import dyes_from_expt_dist as dyes_exp_dist
from . import explicit_r0_calc as r0c

logger = logging.getLogger(__name__)

__all__ = ['FRET_rate', 'calc_dye_radiative_rates',
           'calc_energy_transfer_prob', 'resolve_excitation',
           'resolve_excitations_device',
           'make_dye_msm', 'calc_lifetimes',
           'sample_lifetimes_guarenteed_photon',
           'remake_prot_MSM_from_lifetimes', 'run_mc',
           'calc_per_state_FE', 'fit_lifetimes_single_exp',
           'fit_lifetimes_double_exp',
           'extract_fret_efficiency_lifetimes']

# lockstep steps between two host reads of "is any photon excited"
_BLOCK = 128
# elements a chunk of the alias-table build
_ALIAS_ELEMS = 1 << 24


def FRET_rate(r, R0, Td):
    """kRET = (1/Td) (R0/r)^6. (reference: dye_lifetimes.py:9)"""
    return (1 / Td) * ((R0 / r) ** 6)


def calc_dye_radiative_rates(Qd, Td):
    """(krad, k_non_radiative). (reference: dye_lifetimes.py:29)"""
    krad = Qd / Td
    k_non_rad = (1 / Td) - krad
    return krad, k_non_rad


def calc_energy_transfer_prob(krad, k_non_rad, kRET, dt):
    """[p_radiative, p_nonradiative, p_RET, p_remain_excited] over a
    timestep. (reference: dye_lifetimes.py:53)"""
    rates = np.concatenate([np.ravel(krad), np.ravel(k_non_rad),
                            np.ravel(kRET)]).astype(float)
    decayed = 1.0 - np.exp(-rates * dt)
    remain = 1.0 - decayed.sum()

    probs = np.append(decayed, max(remain, 0.0))
    if remain < 0:
        # timestep too coarse for these rates: renormalize the decay
        # channels instead of carrying a negative survival
        probs /= probs.sum()
    return probs


_OUTCOMES = np.array(['radiative', 'non_radiative', 'energy_transfer',
                      'excited'])


def _pair_k2_r(d_geom, a_geom):
    """(n_d, n_a) kappa^2 and inter-dye-distance tables from 9-column
    dye geometry rows (emission center, dipole origin, dipole vector)
    — the batched form of ``r0c.calc_k2_r`` over every state pair."""
    Dc, Ddo, Dv = d_geom[:, 0:3], d_geom[:, 3:6], d_geom[:, 6:9]
    Ac, Ado, Av = a_geom[:, 0:3], a_geom[:, 3:6], a_geom[:, 6:9]

    r = np.linalg.norm(Dc[:, None] - Ac[None], axis=-1)
    rvec = Ddo[:, None] - Ado[None]                  # (n_d, n_a, 3)
    nr = np.linalg.norm(rvec, axis=-1)
    nD = np.linalg.norm(Dv, axis=-1)
    nA = np.linalg.norm(Av, axis=-1)
    cos_T = (Av @ Dv.T).T / (nD[:, None] * nA[None])
    cos_D = np.einsum('dai,di->da', rvec, Dv) / (nr * nD[:, None])
    cos_A = np.einsum('dai,ai->da', rvec, Av) / (nr * nA[None])
    k2 = (cos_T - 3 * cos_D * cos_A) ** 2
    return k2, r


def _fe_table(d_geom, a_geom, dye_params):
    """(kappa^2, FRET efficiency) tables (n_d, n_a) of two sets of dye
    geometry rows."""
    J, Qd, _Td = dye_params
    k2_tab, r_tab = _pair_k2_r(d_geom, a_geom)
    return k2_tab, dyes_exp_dist.FRET_efficiency(
        r_tab, r0c.calc_R0(k2_tab, Qd, J))


def explicit_static_dyes(d_name, a_name, d_eqs, a_eqs, d_centers,
                         a_centers, dye_params, dyelibrary,
                         n_samples=1000, rng_seed=None):
    """Static-dye treatment: equilibrium dye positions, single coin
    flip per sample — all FRET efficiencies come from one batched
    (n_d, n_a) kappa^2/distance table."""
    return _static_events(_fe_table(
        r0c.assemble_dye_r_mu(d_centers, d_name, dyelibrary),
        r0c.assemble_dye_r_mu(a_centers, a_name, dyelibrary),
        dye_params)[1], d_eqs, a_eqs, n_samples, rng_seed)


def _static_events(FE_tab, d_eqs, a_eqs, n_samples, rng_seed):
    """:func:`explicit_static_dyes` from its efficiency table."""
    rng = np.random.default_rng(rng_seed)
    picks_d = rng.choice(len(d_eqs), p=d_eqs, size=n_samples)
    picks_a = rng.choice(len(a_eqs), p=a_eqs, size=n_samples)
    hops = rng.random(n_samples) <= FE_tab[picks_d, picks_a]
    return [[0, 'energy_transfer' if hop else 'radiative']
            for hop in hops]


def fully_averaged_explict_dyes(d_name, a_name, d_eqs, a_eqs, d_centers,
                                a_centers, dye_params, dyelibrary,
                                n_samples=1000, rng_seed=None):
    """Isotropic treatment, including the reference's quirk: its loop
    (dye_lifetimes.py:162) computes the population-weighted average
    efficiency but then flips every coin on the stale loop variable,
    the LAST (donor, acceptor) pair's efficiency. The weighted tables
    (FE_tab, pair_eqs) are returned for callers who want the average
    the name suggests."""
    return _isotropic_events(
        r0c.assemble_dye_r_mu(d_centers, d_name, dyelibrary),
        r0c.assemble_dye_r_mu(a_centers, a_name, dyelibrary), d_eqs, a_eqs,
        dye_params, n_samples, rng_seed)


def _isotropic_events(d_geom, a_geom, d_eqs, a_eqs, dye_params, n_samples,
                      rng_seed):
    """:func:`fully_averaged_explict_dyes` from the dyes' geometry rows."""
    rng = np.random.default_rng(rng_seed)
    live_d = np.flatnonzero(np.asarray(d_eqs))
    live_a = np.flatnonzero(np.asarray(a_eqs))

    k2_tab, FE_tab = _fe_table(d_geom[live_d], a_geom[live_a], dye_params)
    pair_eqs = np.outer(np.take(d_eqs, live_d), np.take(a_eqs, live_a))

    # reference convention: the coin flip uses the LAST pair's
    # efficiency (dye_lifetimes.py:162 loop-carried FE), kept as-is
    hop_p = float(FE_tab[-1, -1]) if FE_tab.size else 0.0
    transfers = np.where(rng.random(n_samples) <= hop_p,
                         'energy_transfer', 'radiative').astype(object)
    return [[0] * n_samples, transfers, k2_tab.ravel(),
            FE_tab.ravel(), pair_eqs.ravel()]


def resolve_excitation(d_name, a_name, d_tprobs, a_tprobs, d_eqs, a_eqs,
                       d_centers, a_centers, dye_params, dye_lagtime,
                       dyelibrary, rng_seed=None):
    """Monte Carlo of one donor excitation event.
    (reference: dye_lifetimes.py:258)

    Returns ``[steps, outcome, donor_traj, acceptor_traj]``.
    """
    return _walk(r0c.assemble_dye_r_mu(d_centers, d_name, dyelibrary),
                 r0c.assemble_dye_r_mu(a_centers, a_name, dyelibrary),
                 d_tprobs, a_tprobs, d_eqs, a_eqs, dye_params, dye_lagtime,
                 rng_seed)


def _walk(d_geom, a_geom, d_tprobs, a_tprobs, d_eqs, a_eqs, dye_params,
          dye_lagtime, rng_seed):
    """:func:`resolve_excitation` from the dyes' geometry rows."""
    rng = np.random.default_rng(rng_seed)
    J, Qd, Td = dye_params
    krad, k_non_rad = calc_dye_radiative_rates(Qd, Td)

    d_path = [rng.choice(np.arange(d_tprobs.shape[0]), p=d_eqs)]
    a_path = [rng.choice(np.arange(a_tprobs.shape[0]), p=a_eqs)]

    fate = 'excited'
    while fate == 'excited':
        # decay channels from the CURRENT pair geometry...
        k2, r = r0c.calc_k2_r(d_geom[d_path[-1]], a_geom[a_path[-1]])
        kRET = FRET_rate(r, r0c.calc_R0(k2, Qd, J), Td)
        fate = rng.choice(_OUTCOMES, p=calc_energy_transfer_prob(
            krad, k_non_rad, kRET, dye_lagtime))
        # ...then both dye MSMs advance one lag step
        d_path.append(rng.choice(len(d_geom), p=d_tprobs[d_path[-1]]))
        a_path.append(rng.choice(len(a_geom), p=a_tprobs[a_path[-1]]))

    return [len(d_path) - 1, fate, np.array(d_path), np.array(a_path)]


def _pair_rate_tables(d_name, a_name, d_centers, a_centers, dye_params,
                      dye_lagtime, dyelibrary):
    """(n_d, n_a, 4) outcome-probability table for every (donor state,
    acceptor state) pair — the vectorized form of the per-step
    ``calc_k2_r`` -> ``calc_R0`` -> ``FRET_rate`` ->
    ``calc_energy_transfer_prob`` chain in :func:`resolve_excitation`.
    """
    J, Qd, Td = dye_params
    krad, k_non_rad = calc_dye_radiative_rates(Qd, Td)

    k2, r = _pair_k2_r(
        r0c.assemble_dye_r_mu(d_centers, d_name, dyelibrary),
        r0c.assemble_dye_r_mu(a_centers, a_name, dyelibrary))
    R0 = r0c.calc_R0(k2, Qd, J)
    kRET = FRET_rate(r, R0, Td)

    dt = dye_lagtime
    p_rad = 1 - np.exp(-krad * dt)
    p_nonrad = 1 - np.exp(-k_non_rad * dt)
    p_RET = 1 - np.exp(-kRET * dt)
    p_remain = 1 - p_rad - p_nonrad - p_RET
    probs = np.stack([np.broadcast_to(p_rad, r.shape),
                      np.broadcast_to(p_nonrad, r.shape),
                      p_RET, p_remain], axis=-1)
    # clamp the calc_energy_transfer_prob renormalization case
    neg = probs[..., 3] < 0
    probs[..., 3] = np.where(neg, 0.0, probs[..., 3])
    probs /= probs.sum(axis=-1, keepdims=True)
    return probs


def _alias_tables(P):
    """Walker alias tables of the rows of ``P`` (R, n), float64 on its
    device: ``(prob (R, n) float64, alias (R, n) int32)``. Column k of a
    row is drawn with probability 1/n, then kept with ``prob[k]``, else
    replaced by ``alias[k]``. A row of zeros gets ``prob`` 1 (it is never
    drawn from).

    Built for every row at once by the sweep of Huebschle-Schneider and
    Sanders (Parallel weighted random sampling, 2022): with the weights
    scaled to mean 1, the light columns (< 1) in index order take their
    alias from the first heavy column whose running excess covers their
    running deficit; a heavy column retires, keeping what the light ones
    left it, where the running deficit passes its running excess, and
    takes the next heavy column as its alias."""
    R, n = P.shape
    dev = P.device
    mass = P.sum(dim=1, keepdim=True)
    W = torch.where(mass > 0, P / torch.where(mass > 0, mass, 1.0) * n, 1.0)
    light = W < 1
    n_light = light.sum(dim=1, keepdim=True)
    # the light columns first, then the heavy ones, each in index order
    pos = torch.where(light, light.cumsum(1) - 1,
                      n_light + (~light).cumsum(1) - 1)
    cols = torch.arange(n, device=dev).expand(R, n)
    order = torch.empty_like(pos).scatter_(1, pos, cols)
    Ws = W.gather(1, order)
    is_light = cols < n_light
    deficit = torch.where(is_light, 1 - Ws, 0.0)
    D = deficit.cumsum(1)
    excess = torch.where(is_light, 0.0, Ws - 1)
    S = torch.where(is_light, -1.0, excess.cumsum(1))
    # a light column's alias: the first heavy column with S >= D before it
    q = torch.searchsorted(S, (D - deficit).contiguous()).clamp_(max=n - 1)
    # a heavy column retires where D first passes its S
    at = torch.searchsorted(D, S.contiguous(), right=True)
    nxt = cols + 1
    retire = ~is_light & (at < n_light) & (nxt < n)
    left = 1 - (D.gather(1, at.clamp(max=n - 1)) - S)
    prob_s = torch.where(is_light, Ws, torch.where(retire, left, 1.0))
    alias_s = torch.where(is_light, q, torch.where(retire, nxt, cols))
    prob = torch.empty_like(prob_s).scatter_(1, order, prob_s)
    alias = torch.empty_like(order).scatter_(1, order,
                                             order.gather(1, alias_s))
    return prob, alias.to(torch.int32)


def _stacked_alias(mats, device):
    """Alias tables of the rows of every matrix of ``mats`` (each m x n,
    host), stacked: ``(prob (len * m, n), alias (len * m, n))`` on
    ``device``, built a chunk of matrices at a time. Negative entries (an
    eigensolver's rounding) count as 0, as the JAX lockstep's
    ``log(max(p, 1e-300))`` has them."""
    m, n = np.shape(mats[0])
    per = max(1, _ALIAS_ELEMS // max(m * n, 1))
    probs, aliases = [], []
    for lo in range(0, len(mats), per):
        block = torch.as_tensor(np.stack(
            [np.asarray(x, np.float64) for x in mats[lo:lo + per]]),
            device=device).reshape(-1, n).clamp_(min=0)
        p, a = _alias_tables(block)
        probs.append(p)
        aliases.append(a)
    return torch.cat(probs), torch.cat(aliases)


def _draw(prob, alias, row, u, n):
    """One state of each row ``row`` of the alias tables (flattened rows of
    width ``n``) from the uniforms ``u``: the column from ``u * n``, the
    coin from its fraction."""
    x = u * n
    k = x.long().clamp_(max=n - 1)
    flat = row * n + k
    return torch.where(x - k < prob.reshape(-1)[flat], k,
                       alias.reshape(-1)[flat].long())


def _lockstep(probs, d_tprobs, a_tprobs, d_eqs, a_eqs, n_samples,
              max_steps, generator, device):
    """The lockstep Monte Carlo of ``n_samples`` photons for each of C
    protein conformations, all in one loop on ``device``.

    ``probs`` (n_d, n_a, 4): outcome probabilities of a (donor state,
    acceptor state) pair, shared by every conformation; ``d_tprobs``,
    ``a_tprobs``: the C dye transition matrices; ``d_eqs``, ``a_eqs``:
    their C start distributions. Each step draws the outcome of the
    current pair (0 radiative, 1 non-radiative, 2 energy transfer, 3
    still excited); ``steps`` grows by one for each photon still excited
    before the draw; then both dyes of each photon still excited move one
    lag. The host reads the photons still excited every ``_BLOCK`` steps
    and drops the others. Returns ``(steps (C, n_samples) int64, outcome
    (C, n_samples) int64, lockstep steps run)``."""
    C = len(d_tprobs)
    n_d, n_a = probs.shape[:2]
    P = C * n_samples
    if P == 0:
        return (np.zeros((C, n_samples), np.int64),
                np.zeros((C, n_samples), np.int64), 0)
    cum = torch.as_tensor(np.cumsum(probs[..., :3], axis=-1)
                          .reshape(-1, 3), dtype=torch.float64,
                          device=device)
    d_prob, d_alias = _stacked_alias(d_tprobs, device)
    a_prob, a_alias = _stacked_alias(a_tprobs, device)
    de_prob, de_alias = _stacked_alias([np.reshape(d_eqs, (C, n_d))], device)
    ae_prob, ae_alias = _stacked_alias([np.reshape(a_eqs, (C, n_a))], device)

    center = torch.arange(C, device=device).repeat_interleave(n_samples)
    u = torch.rand((P, 2), generator=generator, dtype=torch.float64,
                   device=device)
    d = _draw(de_prob, de_alias, center, u[:, 0], n_d)
    a = _draw(ae_prob, ae_alias, center, u[:, 1], n_a)
    row_d, row_a = center * n_d, center * n_a

    steps_out = torch.zeros(P, dtype=torch.int64, device=device)
    outcome_out = torch.full((P,), 3, dtype=torch.int64, device=device)
    idx = torch.arange(P, device=device)
    steps = torch.zeros(P, dtype=torch.int64, device=device)
    outcome = torch.full((P,), 3, dtype=torch.int64, device=device)
    alive = torch.ones(P, dtype=torch.bool, device=device)
    step = 0
    while step < max_steps:
        for _ in range(min(_BLOCK, max_steps - step)):
            u = torch.rand((len(idx), 3), generator=generator,
                           dtype=torch.float64, device=device)
            o = (u[:, :1] >= cum[d * n_a + a]).sum(dim=1)
            outcome = torch.where(alive & (o != 3), o, outcome)
            steps += alive
            alive &= o == 3
            d = torch.where(alive, _draw(d_prob, d_alias, row_d + d,
                                         u[:, 1], n_d), d)
            a = torch.where(alive, _draw(a_prob, a_alias, row_a + a,
                                         u[:, 2], n_a), a)
            step += 1
        steps_out[idx] = steps
        outcome_out[idx] = outcome
        keep = torch.nonzero(alive).squeeze(1)
        if len(keep) == 0:
            break
        idx, d, a, row_d, row_a, steps, outcome = (
            t[keep] for t in (idx, d, a, row_d, row_a, steps, outcome))
        alive = alive[keep]
    return (steps_out.reshape(C, n_samples).cpu().numpy(),
            outcome_out.reshape(C, n_samples).cpu().numpy(), step)


def _default_max_steps(dye_params, dye_lagtime):
    # 30 donor lifetimes: residual survival < 1e-13
    return int(np.ceil(30.0 * float(np.ravel(dye_params[2])[0])
                       / dye_lagtime)) + 1


def resolve_excitations_device(d_name, a_name, d_tprobs, a_tprobs,
                               d_eqs, a_eqs, d_centers, a_centers,
                               dye_params, dye_lagtime, dyelibrary=None,
                               n_samples=1000, rng_seed=0,
                               max_steps=None, generator=None, device=None):
    """All-photon Monte Carlo on ``device`` (default: the card): every
    excitation advances in lockstep, per step one outcome draw from the
    current (donor, acceptor) pair's row of the outcome table and one
    alias-table draw for each dye MSM. Replaces the reference's
    per-photon Python loop (dye_lifetimes.py:258) when thousands of
    photons are sampled; statistically identical but NOT bit-matched.
    ``generator`` is a ``torch.Generator`` on ``device``; without one,
    one is seeded with ``rng_seed``.

    Returns ``(steps (n,), outcomes (n,) str)`` matching
    :func:`resolve_excitation` semantics (steps counts the emission
    step; outcome is the decay channel).
    """
    dev = resolve_device(d_tprobs, device)
    if dyelibrary is None:
        dyelibrary = r0c.load_library()
    if max_steps is None:
        max_steps = _default_max_steps(dye_params, dye_lagtime)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(rng_seed))
    probs = _pair_rate_tables(d_name, a_name, d_centers, a_centers,
                              dye_params, dye_lagtime, dyelibrary)
    steps, outcome, _ = _lockstep(
        probs, [np.asarray(d_tprobs)], [np.asarray(a_tprobs)],
        np.asarray(d_eqs)[None], np.asarray(a_eqs)[None], n_samples,
        max_steps, generator, dev)
    return steps[0].astype(np.int32), _OUTCOMES[outcome[0]]


def make_dye_msm(centers, t_counts, pdb, resseq, dyename, dyelibrary,
                 center_n=None, outdir='./', save_dye_xtc=False,
                 device=None):
    """Align a dye to a residue, drop clashed states (the clash test on
    ``device``, default: the card), rebuild the dye MSM.
    (reference: dye_lifetimes.py:360)"""
    placed = centers.copy()
    placed.xyz = r0c.align_full_dye_to_res(pdb, placed, resseq,
                                           dyename, dyelibrary)
    keep = r0c.remove_touches_protein_dye_traj(pdb, placed, resseq,
                                               device=device)
    return _dye_msm(centers, placed.xyz, keep, t_counts, resseq, dyename,
                    center_n, outdir, save_dye_xtc)


def _dye_msm(centers, xyz, keep, t_counts, resseq, dyename, center_n,
             outdir, save_dye_xtc):
    """:func:`make_dye_msm` once the dye ``centers`` is placed at ``xyz``
    and its kept frames ``keep`` known."""
    if len(keep) == 0:
        return np.array([0]), np.array([0]), np.array([])

    if save_dye_xtc:
        tag = ''.join(dyename.split(' '))
        placed = centers[list(keep)]
        placed.xyz = xyz[keep]
        placed.save(os.path.join(
            outdir, f'center{center_n}-aligned-to-{resseq}-{tag}.xtc'))

    clashed = np.setdiff1d(np.arange(len(xyz)), keep)
    pruned = r0c.remove_bad_states(clashed, t_counts)
    tprobs, eqs = builders.normalize(pruned, calculate_eq_probs=True)[1:]
    return tprobs, eqs, keep


def _save_dye_msms(outdir, center_n, dyenames, resSeqs, msms):
    for (tprobs, eqs, _), name, res in zip(msms, dyenames, resSeqs):
        np.save('%s/center%s-%s-%s-eqs.npy' % (
            outdir, center_n, ''.join(name.split(' ')), res), eqs)
    for (tprobs, eqs, _), name, res in zip(msms, dyenames, resSeqs):
        np.save('%s/center%s-%s-%s-tps.npy' % (
            outdir, center_n, ''.join(name.split(' ')), res), tprobs)


def _host_treatment(msms, geoms, fe_table, dyenames, resSeqs, dye_params,
                    dye_lagtime, n_samples, dye_treatment, outdir, center_n,
                    save_dye_trj, save_k2_r2, rng_seed):
    """(lifetimes, outcomes, tables) of one protein conformation by a host
    treatment ('Monte-carlo', 'static' or 'isotropic') from its two dye
    MSMs ``msms`` = [(tprobs, eqs, kept)] * 2, the dyes' geometry rows
    ``geoms`` and, for 'static', their efficiency table; ``tables`` are
    isotropic's per-pair (k2s, FEs, eqs) when ``save_k2_r2``, else None."""
    (d_tprobs, d_mod_eqs, d_indxs), (a_tprobs, a_mod_eqs, a_indxs) = msms
    tables = None
    if dye_treatment == 'Monte-carlo':
        seeds = np.random.SeedSequence(rng_seed).spawn(n_samples)
        events = np.array([
            _walk(*geoms, d_tprobs, a_tprobs, d_mod_eqs, a_mod_eqs,
                  dye_params, dye_lagtime, seeds[i])
            for i in range(n_samples)], dtype='O')

        if save_dye_trj:
            if len(d_indxs) > 0:
                dtrj = np.array([np.searchsorted(d_indxs, e)
                                 for e in events[:, 2]], dtype=object)
                np.save('%s/center%s-%s-%s-dtrj.npy' % (
                    outdir, center_n, dyenames[0], resSeqs[0]), dtrj)
            if len(a_indxs) > 0:
                atrj = np.array([np.searchsorted(a_indxs, e)
                                 for e in events[:, 3]], dtype=object)
                np.save('%s/center%s-%s-%s-atrj.npy' % (
                    outdir, center_n, dyenames[1], resSeqs[1]), atrj)
        lifetimes = events[:, 0]
        outcomes = events[:, 1]
    elif dye_treatment == 'static':
        events = np.array(_static_events(fe_table, d_mod_eqs, a_mod_eqs,
                                         n_samples, rng_seed), dtype='O')
        lifetimes = events[:, 0]
        outcomes = events[:, 1]
    else:
        lifetimes, outcomes, *tables = _isotropic_events(
            *geoms, d_mod_eqs, a_mod_eqs, dye_params, n_samples, rng_seed)
        if not save_k2_r2:
            tables = None

    lifetimes = np.array(lifetimes, dtype=float) * dye_lagtime  # ns
    return lifetimes, outcomes, tables


def _check_treatment(dye_treatment, save_dye_trj):
    if dye_treatment not in ('Monte-carlo', 'Monte-carlo-device', 'static',
                             'isotropic'):
        raise ValueError('Unknown dye_treatment %r' % dye_treatment)
    if dye_treatment == 'Monte-carlo-device' and save_dye_trj:
        raise exception.ImproperlyConfigured(
            "save_dye_trj requires dye_treatment='Monte-carlo': "
            'the lockstep device MC does not record per-photon '
            'state paths')


def calc_lifetimes(pdb_center_num, d_centers, d_tcounts, a_centers,
                   a_tcounts, resSeqs, dyenames, dye_lagtime,
                   n_samples=1000, dye_treatment='Monte-carlo',
                   outdir='./', save_dye_trj=False, save_dye_msm=False,
                   save_dye_centers=False, save_k2_r2=False,
                   rng_seed=None, device=None):
    """Dye-emission lifetimes and outcomes for one protein center; the
    clash tests and 'Monte-carlo-device' on ``device`` (default: the
    card). (reference: dye_lifetimes.py:422)"""
    pdb, center_n = pdb_center_num
    events, _ = _calc_lifetimes_all(
        pdb[0], d_centers, d_tcounts, a_centers, a_tcounts, resSeqs,
        dyenames, dye_lagtime, n_samples=n_samples,
        dye_treatment=dye_treatment, outdir=outdir,
        save_dye_trj=save_dye_trj, save_dye_msm=save_dye_msm,
        save_dye_centers=save_dye_centers, save_k2_r2=save_k2_r2,
        rng_seed=rng_seed, center_ns=[center_n], device=device)
    return events[0]


def _calc_lifetimes_all(prot, d_centers, d_tcounts, a_centers, a_tcounts,
                        resSeqs, dyenames, dye_lagtime, n_samples=1000,
                        dye_treatment='Monte-carlo', outdir='./',
                        save_dye_trj=False, save_dye_msm=False,
                        save_dye_centers=False, save_k2_r2=False,
                        rng_seed=None, center_ns=None, n_procs=1,
                        device=None):
    """:func:`calc_lifetimes` of every frame of the protein trajectory
    ``prot`` at once: both dyes placed on every frame (``n_procs`` host
    threads), one clash test of every placement on ``device``, the dye
    MSMs rebuilt a frame at a time on the host, then either one lockstep
    Monte Carlo of every frame's photons ('Monte-carlo-device', seeded
    once with ``rng_seed``) or the host treatment a frame at a time.
    Returns ``([(lifetimes, outcomes)] per frame, info)``: ``info`` holds
    the seconds of each stage ('placement', 'clash', 'msm', 'treatment'),
    the clash test's (dye atom, protein atom) 'tests', the dye states
    'kept' (for each dye a list of each frame's kept indices) and, for the
    lockstep, its 'lockstep_steps' and 'photon_steps'."""
    _check_treatment(dye_treatment, save_dye_trj)
    dev = resolve_device(prot.xyz, device)
    if center_ns is None:
        center_ns = list(range(len(prot)))
    dyelibrary = r0c.load_library()
    dye_params = r0c.get_dye_overlap(dyenames[0], dyenames[1])
    info = {'placement': 0.0, 'clash': 0.0, 'tests': 0.0}

    placements = []
    for dye, res, name in ((d_centers, resSeqs[0], dyenames[0]),
                           (a_centers, resSeqs[1], dyenames[1])):
        xyz, kept, t = r0c._place_and_prune(prot, dye, res, name,
                                            dyelibrary, n_procs=n_procs,
                                            device=dev)
        for k in info:
            info[k] += t[k]
        placements.append((dye, xyz, kept))
    info['kept'] = [p[2] for p in placements]

    def rebuild(i):
        return [_dye_msm(dye, xyz[i], kept[i], counts, res, name,
                         center_ns[i], outdir, save_dye_centers)
                for (dye, xyz, kept), counts, res, name in zip(
                    placements, (d_tcounts, a_tcounts), resSeqs, dyenames)]

    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(n_procs, 1)) as pool:
        msms = list(pool.map(rebuild, range(len(prot))))
    info['msm'] = time.perf_counter() - t
    live = [i for i, m in enumerate(msms)
            if np.sum(m[0][1]) != 0 and np.sum(m[1][1]) != 0]
    if save_dye_msm:
        for i in live:
            _save_dye_msms(outdir, center_ns[i], dyenames, resSeqs, msms[i])

    events = [([], [])] * len(prot)
    t = time.perf_counter()
    if dye_treatment == 'Monte-carlo-device' and live:
        gen = torch.Generator(device=dev).manual_seed(
            int(rng_seed) if rng_seed is not None else 0)
        probs = _pair_rate_tables(dyenames[0], dyenames[1], d_centers,
                                  a_centers, dye_params, dye_lagtime,
                                  dyelibrary)
        steps, outcome, info['lockstep_steps'] = _lockstep(
            probs, [msms[i][0][0] for i in live],
            [msms[i][1][0] for i in live],
            np.array([msms[i][0][1] for i in live]),
            np.array([msms[i][1][1] for i in live]),
            n_samples, _default_max_steps(dye_params, dye_lagtime), gen,
            dev)
        info['photon_steps'] = int(steps.sum())
        for j, i in enumerate(live):
            events[i] = (np.array(steps[j].astype(np.int32), dtype=float)
                         * dye_lagtime, _OUTCOMES[outcome[j]])
    elif dye_treatment != 'Monte-carlo-device':
        # the tables of the unplaced dyes, shared by every center
        geoms = [r0c.assemble_dye_r_mu(c, name, dyelibrary)
                 for c, name in zip((d_centers, a_centers), dyenames)]
        fe_table = (_fe_table(*geoms, dye_params)[1]
                    if dye_treatment == 'static' else None)

        def treat(i):
            return _host_treatment(
                msms[i], geoms, fe_table, dyenames, resSeqs, dye_params,
                dye_lagtime, n_samples, dye_treatment, outdir, center_ns[i],
                save_dye_trj, save_k2_r2, rng_seed)
        with ThreadPoolExecutor(max_workers=max(n_procs, 1)) as pool:
            for i, (*ev, tables) in zip(live, pool.map(treat, live)):
                events[i] = tuple(ev)
                if tables is not None:
                    # one file a residue pair: the last center's, as a
                    # run of the centers in order leaves it
                    for tag, x in zip(('k2s', 'FEs', 'eqs'), tables):
                        np.save('%s/%s-%s-per_state_%s.npy'
                                % (outdir, resSeqs[0], resSeqs[1], tag), x)
    info['treatment'] = time.perf_counter() - t
    return events, info


def _sample_lifetimes_guarenteed_photon(states, lifetimes, outcomes,
                                        rng_seed=None):
    """Draw (photon id, lifetime) per visited state, redrawing
    non-radiative events. (reference: dye_lifetimes.py:535)"""
    rng = np.random.default_rng(rng_seed)
    channel = {'radiative': 0, 'energy_transfer': 1}

    photons = np.empty(len(states), dtype=int)
    lts = np.empty(len(states))
    for i, state in enumerate(states):
        n_events = len(lifetimes[state])
        if all(o == 'non_radiative' for o in outcomes[state]):
            # the reference's redraw loop (dye_lifetimes.py:535) hangs
            # forever here; fail loudly instead
            raise exception.DataInvalid(
                'state %s has only non-radiative events (n=%d): no '
                'photon can be drawn — increase n_samples or check '
                'the dye rates' % (state, n_events))
        pick = rng.choice(n_events)
        while outcomes[state][pick] == 'non_radiative':
            pick = rng.choice(n_events)    # no photon: redraw
        if outcomes[state][pick] not in channel:
            raise ValueError(
                'Unexpected outcome %r for state %s event %s'
                % (outcomes[state][pick], state, pick))
        photons[i] = channel[outcomes[state][pick]]
        lts[i] = lifetimes[state][pick]
    return photons, lts


def sample_lifetimes_guarenteed_photon(frames, t_probs, eqs, lifetimes,
                                       outcomes, rng_seed=None):
    """One burst: protein-MSM chain + guaranteed photons at the given
    frames. (reference: dye_lifetimes.py:587)"""
    rng = np.random.default_rng(rng_seed)
    start = rng.choice(t_probs.shape[0], p=eqs)
    chain = synthetic_data.synthetic_trajectory(
        t_probs, start, int(np.amax(frames)) + 1, random_state=rng)

    visited = chain[frames]
    photons, lts = _sample_lifetimes_guarenteed_photon(
        visited, lifetimes, outcomes, rng_seed=rng)
    return photons, lts, visited


def remake_prot_MSM_from_lifetimes(lifetimes, prot_tcounts, resSeqs,
                                   dyenames, outdir='./',
                                   prot_eqs=None):
    """Rebuild the protein MSM after removing unlabelable states.
    (reference: dye_lifetimes.py:633)"""
    bad_states = r0c.find_dyeless_states(lifetimes)
    logger.info('%d of %d protein states had steric clashes for '
                'labeling pair: %s-%s.', len(bad_states),
                len(prot_tcounts), resSeqs[0], resSeqs[1])

    if prot_eqs is not None and len(bad_states):
        lost = np.sum(np.asarray(prot_eqs)[bad_states])
        logger.info('This was %.2f%% of the original equilibrium '
                    'probability.', 100 * lost)
        if lost > 0.2:
            logger.warning('Lots of equilibrium probability lost.')

    trimmed = r0c.remove_bad_states(bad_states, prot_tcounts)
    _, new_tprobs, new_eqs = builders.normalize(
        trimmed, calculate_eq_probs=True)

    os.makedirs(outdir, exist_ok=True)
    base = '%s-%s-%s-%s' % (resSeqs[0], ''.join(dyenames[0].split(' ')),
                            resSeqs[1], ''.join(dyenames[1].split(' ')))
    np.save(os.path.join(outdir, base + '-eqs.npy'), new_eqs)
    np.save(os.path.join(outdir, base + '-t_prbs.npy'), new_tprobs)
    return new_tprobs, new_eqs


def run_mc(resSeq, prot_tcounts, dyenames, MSM_frames, dye_dir, outdir,
           time_correction, save_photon_trjs=False,
           save_burst_frames=False, rng_seed=None):
    """Full burst MC for one labeling pair, reading the per-center
    lifetime events from disk. (reference: dye_lifetimes.py:702)"""
    events_path = os.path.join(
        dye_dir, 'events-%s-%s.npy' % (resSeq[0], resSeq[1]))
    lifetime_outcomes = np.load(events_path, allow_pickle=True)

    lifets = lifetime_outcomes[:, 0]
    outcomes = lifetime_outcomes[:, 1]

    base = '%s-%s-%s-%s' % (resSeq[0], ''.join(dyenames[0].split(' ')),
                            resSeq[1], ''.join(dyenames[1].split(' ')))
    new_tprobs = np.load(os.path.join(outdir, 'MSMs',
                                      base + '-t_prbs.npy'))
    new_eqs = np.load(os.path.join(outdir, 'MSMs', base + '-eqs.npy'))

    seeds = np.random.SeedSequence(rng_seed).spawn(len(MSM_frames))
    sampling = np.array([
        sample_lifetimes_guarenteed_photon(
            frames, new_tprobs, new_eqs, lifets, outcomes,
            rng_seed=seeds[i])
        for i, frames in enumerate(MSM_frames)], dtype='O')

    if save_burst_frames:
        os.makedirs(os.path.join(outdir, 'protein-trajs'),
                    exist_ok=True)
        np.save(os.path.join(
            outdir, 'protein-trajs',
            '%s-%s-%s.npy' % (resSeq[0], resSeq[1], time_correction)),
            sampling[:, 2])

    FEs, d_lifetimes, a_lifetimes = \
        extract_fret_efficiency_lifetimes(sampling)

    os.makedirs(os.path.join(outdir, 'Lifetimes'), exist_ok=True)
    os.makedirs(os.path.join(outdir, 'FEs'), exist_ok=True)
    if save_photon_trjs:
        photon_ids = ra.RaggedArray([b for b in sampling[:, 0]])
        ra.save(os.path.join(
            outdir, 'FEs', 'photon-trace-%s-%s-%s.h5'
            % (resSeq[0], resSeq[1], time_correction)), photon_ids)
    np.save(os.path.join(outdir, 'FEs', 'FE-%s-%s-%s.npy'
                         % (resSeq[0], resSeq[1], time_correction)),
            FEs)
    np.save(os.path.join(
        outdir, 'Lifetimes', 'd_lifetimes-%s-%s-%s.npy'
        % (resSeq[0], resSeq[1], time_correction)), d_lifetimes)
    np.save(os.path.join(
        outdir, 'Lifetimes', 'a_lifetimes-%s-%s-%s.npy'
        % (resSeq[0], resSeq[1], time_correction)), a_lifetimes)
    return FEs, d_lifetimes, a_lifetimes


def remake_msms(resSeq, prot_tcounts, dye_dir, dyenames, orig_eqs,
                outdir):
    """(reference: dye_lifetimes.py:688)"""
    events_path = os.path.join(
        dye_dir, 'events-%s-%s.npy' % (resSeq[0], resSeq[1]))
    lifetime_outcomes = np.load(events_path, allow_pickle=True)
    lifets = lifetime_outcomes[:, 0]
    return remake_prot_MSM_from_lifetimes(
        lifets, prot_tcounts, resSeq, dyenames,
        outdir=os.path.join(outdir, 'MSMs'), prot_eqs=orig_eqs)


def calc_per_state_FE(events):
    """FRET efficiency per protein state from a lifetimes/outcomes
    events array. (reference: dye_lifetimes.py:746)"""
    ratios = np.full(len(events), np.nan)
    for i, outcomes in enumerate(events[:, 1]):
        outcomes = np.asarray(outcomes)
        if outcomes.size:
            via_transfer = np.count_nonzero(
                outcomes == 'energy_transfer')
            emitted = via_transfer + np.count_nonzero(
                outcomes == 'radiative')
            ratios[i] = via_transfer / emitted
    return ratios


def single_exp_decay(t, Io, tau):
    """(reference: dye_lifetimes.py:772)"""
    return Io * np.exp(-t / tau)


def _fit_decay(model, t, y, p0):
    return curve_fit(model, t, y, p0=p0)[0]


def fit_single_exp(t, y, p0):
    return tuple(_fit_decay(single_exp_decay, t, y, p0))


def _lifetime_hist(lifetimes, hist_bins, hist_range):
    counts, edges = np.histogram(lifetimes, range=hist_range,
                                 bins=hist_bins)
    return (edges[:-1] + edges[1:]) / 2, counts


def _donor_Td(donor_name):
    if donor_name is None:
        return np.array([4.0])
    _, _, Td = r0c.get_dye_overlap(donor_name, donor_name)
    return Td


def fit_lifetimes_single_exp(lifetimes, donor_name=None, hist_bins=100,
                             hist_range=(0, 25)):
    """(reference: dye_lifetimes.py:795)"""
    t, counts = _lifetime_hist(lifetimes, hist_bins, hist_range)
    Td = _donor_Td(donor_name)
    Io = np.amax(counts)
    fit_I, fit_tau = fit_single_exp(t, counts,
                                    p0=np.array([Io, Td[0]]))
    return t, counts, fit_I, fit_tau


def double_exp_decay(t, Io1, Io2, tau1, tau2):
    """(reference: dye_lifetimes.py:842)"""
    return Io1 * np.exp(-t / tau1) + Io2 * np.exp(-t / tau2)


def fit_double_exp(t, y, p0):
    return tuple(_fit_decay(double_exp_decay, t, y, p0))


def fit_lifetimes_double_exp(lifetimes, donor_name=None, hist_bins=100,
                             hist_range=(0, 25)):
    """(reference: dye_lifetimes.py:868)"""
    t, counts = _lifetime_hist(lifetimes, hist_bins, hist_range)
    guess_tau = _donor_Td(donor_name)[0]
    half = np.amax(counts) / 2
    fits = fit_double_exp(
        t, counts, p0=np.array([half, half, guess_tau, guess_tau]))
    return (t, counts) + fits


def fit_lifetimes_single_exp_high_throughput(
        lifetimes, donor_name=None, hist_bins=100, hist_range=(0, 25)):
    """(reference: dye_lifetimes.py:952)"""
    t, counts = _lifetime_hist(lifetimes, hist_bins, hist_range)
    Td = _donor_Td(donor_name)
    Io = np.amax(counts)
    try:
        fit_I, fit_tau = fit_single_exp(t, counts,
                                        p0=np.array([Io, Td[0]]))
    except RuntimeError:
        return t, counts, 0, 100
    return t, counts, fit_I, fit_tau


def extract_fret_efficiency_lifetimes(lifetime_samples):
    """(reference: dye_lifetimes.py:919)"""
    FEs, from_donor, from_acceptor = [], [], []
    for burst in lifetime_samples:
        photons = np.asarray(burst[0])
        lts = np.asarray(burst[1])
        FEs.append(photons.sum() / len(photons))
        from_donor.append(lts[photons == 0])
        from_acceptor.append(lts[photons == 1])
    return (np.array(FEs), np.array(from_donor, dtype=object),
            np.array(from_acceptor, dtype=object))
