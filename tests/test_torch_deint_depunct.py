"""Parity of the receive step's fused chain (the plain twin of kernel K4's
mode (b), deinterleave_depuncture_t_ref) with tpudab's own chain on the
same numpy-seeded inputs: subch_cif_slices, the concatenation with the
carry, deinterleave_batch (the XLA path, and the Pallas kernel in
interpret mode), the body cut and tpudab.fec.depuncture.depuncture_t.
Tolerance: none. The Viterbi input and the new carries are held bit for
bit, since every step only selects."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.constants.dab_params import get_dab_params as jax_dab_params
from tpudab.constants.puncture import FIC_PROFILE as JAX_FIC, eep_profile as jax_eep
from tpudab.constants.puncture import get_uep_profile as jax_uep
from tpudab.fec.depuncture import depuncture_t as jax_depuncture_t
from tpudab.msc.interleave import _deinterleave_xla, deinterleave_pallas
from tpudab.msc.subchannel import SubchannelConfig as JaxConfig, subch_cif_slices as jax_slices
from tpudab_torch.constants.dab_params import CU_BITS, get_dab_params
from tpudab_torch.constants.puncture import FIC_PROFILE, eep_profile, get_uep_profile
from tpudab_torch.fec.depuncture import depuncture_index, depuncture_t
from tpudab_torch.msc.interleave import (SoftRows, deinterleave_depuncture_t,
                                         deinterleave_depuncture_t_ref, deinterleave_ref)
from tpudab_torch.msc.subchannel import SubchannelConfig, subch_cif_slices

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DAB = get_dab_params(1)

# (start CU, size CU) of each subchannel in one group, and its profile
GROUPS = {
    "eep3a_pair": ([(0, 24), (36, 24)], lambda: (eep_profile(24, 3, 0), 0),
                   lambda: (jax_eep(24, 3, 0), 0)),
    "uep128_pl3": ([(108, 96)], lambda: (get_uep_profile(128, 3).to_profile(),
                                         get_uep_profile(128, 3).padding_bits),
                   lambda: (jax_uep(128, 3).to_profile(), jax_uep(128, 3).padding_bits)),
}


def as_torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(x).to(TORCH_DT[dtype])


def as_jax(x: np.ndarray, dtype: str):
    return jnp.asarray(x).astype(jnp.dtype(dtype))


def bits_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def inputs(n_ens: int, c: int, layout, dtype: str, seed: int):
    """Flat soft (E*F, nb_frame_bits) and a nonzero carry per subchannel,
    f32 numpy rounded to dtype."""
    rng = np.random.default_rng(seed)
    f = c // DAB.nb_cifs
    soft = rng.standard_normal((n_ens * f, DAB.nb_frame_bits), dtype=np.float32)
    lead = (n_ens,) if n_ens > 1 else ()
    carries = [rng.standard_normal(lead + (15, size * CU_BITS), dtype=np.float32)
               for _, size in layout]
    rnd = lambda x: bits_np(as_torch(x, dtype))
    return rnd(soft), [rnd(x) for x in carries]


def tpudab_chain(soft, carries, layout, profile, padding, n_ens, c, dtype, deint):
    """tpudab's step chain (tpudab/models/step.py:139-170) for one group."""
    s = jnp.asarray(soft).astype(jnp.dtype(dtype))
    logicals, new = [], []
    for (start, size), carry in zip(layout, carries):
        cfg = JaxConfig(1, start, size, profile, padding)
        sl = jax_slices(s, cfg, DAB.nb_fic_bits, DAB.nb_cifs)
        sl = sl.reshape((n_ens, c, size * CU_BITS) if n_ens > 1 else (c, size * CU_BITS))
        buf = jnp.concatenate([as_jax(carry, dtype), sl], axis=-2)
        logicals.append(deint(buf, c).reshape(-1, size * CU_BITS))
        new.append(np.asarray(buf[..., -15:, :].astype(jnp.float32)))
    logical = jnp.concatenate(logicals, axis=0)
    body = logical[:, : logical.shape[1] - padding] if padding else logical
    return np.asarray(jax_depuncture_t(body, profile).astype(jnp.float32)), new


def port_chain(soft, carries, layout, profile, padding, n_ens, c, dtype, chain):
    """The port's chain for one group: one call of `chain` per subchannel
    into one (T2p, 8, B) tensor, as ReceiveStep.decode_soft runs it."""
    st = as_torch(soft, dtype)
    index = torch.from_numpy(depuncture_index(profile))
    n = n_ens * c
    out = st.new_full((index.shape[0] // 8, 8, len(layout) * n), float("nan"))
    new = []
    for i, ((start, size), carry) in enumerate(zip(layout, carries)):
        rows = SoftRows.cif_slices(DAB.nb_fic_bits, DAB.nb_cifs, start * CU_BITS,
                                   size * CU_BITS)
        new.append(chain(st, rows, as_torch(carry, dtype), index,
                         profile.punctured_bits, out, i * n))
    assert profile.punctured_bits == layout[0][1] * CU_BITS - padding
    return out, new


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("c", [4, 8, 20])
@pytest.mark.parametrize("n_ens", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_matches_tpudab(dtype, n_ens, c, group):
    """Viterbi input and new carries bit-equal to tpudab's chain, with the
    deinterleave on its XLA path and on its Pallas kernel (interpret)."""
    layout, port_profile, jax_profile = GROUPS[group]
    profile, padding = port_profile()
    jprofile, jpadding = jax_profile()
    soft, carries = inputs(n_ens, c, layout, dtype, seed=c + 10 * n_ens)
    got, new = port_chain(soft, carries, layout, profile, padding, n_ens, c, dtype,
                          deinterleave_depuncture_t)
    pallas = lambda buf, c: deinterleave_pallas(buf, c, interpret=True)
    for deint in (_deinterleave_xla, pallas):
        want, want_new = tpudab_chain(soft, carries, layout, jprofile, jpadding, n_ens, c,
                                      dtype, deint)
        assert got.dtype == TORCH_DT[dtype]
        np.testing.assert_array_equal(bits_np(got), want)
        for g, w in zip(new, want_new):
            assert g.dtype == TORCH_DT[dtype]
            np.testing.assert_array_equal(bits_np(g), w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_frames", [1, 3])
def test_fic_matches_tpudab(dtype, n_frames):
    """Depth 1: codeword frame * 4 + g is FIB group g of the frame, held
    bit-equal to tpudab's depuncture_t of soft[:, :nb_fic_bits] groups."""
    rng = np.random.default_rng(n_frames)
    soft = bits_np(as_torch(rng.standard_normal((n_frames, DAB.nb_frame_bits),
                                                dtype=np.float32), dtype))
    jd = jax_dab_params(1)
    groups = jnp.asarray(soft[:, : jd.nb_fic_bits]).astype(jnp.dtype(dtype)).reshape(
        -1, jd.nb_fic_bits_per_group)
    want = np.asarray(jax_depuncture_t(groups, JAX_FIC).astype(jnp.float32))
    index = torch.from_numpy(depuncture_index(FIC_PROFILE))
    out = as_torch(soft, dtype).new_full((index.shape[0] // 8, 8, n_frames * 4), float("nan"))
    rows = SoftRows.fib_groups(DAB.nb_fib_groups, DAB.nb_fic_bits_per_group)
    assert deinterleave_depuncture_t(as_torch(soft, dtype), rows, None, index,
                                     FIC_PROFILE.punctured_bits, out) is None
    np.testing.assert_array_equal(bits_np(out), want)


def old_composition(st, rows, carry, index, n_punct, out, col0, cfg):
    """The port's step chain before the fusion: subch_cif_slices, cat,
    deinterleave_ref, the body cut, depuncture_t."""
    lead = carry.shape[:-2]
    c = st.shape[0] // (lead[0] if lead else 1) * DAB.nb_cifs
    sl = subch_cif_slices(st, cfg, DAB.nb_fic_bits, DAB.nb_cifs).reshape(
        lead + (c, cfg.slice_bits))
    buf = torch.cat([carry, sl], dim=-2)
    logical = deinterleave_ref(buf, c).reshape(-1, cfg.slice_bits)
    body = logical[:, :n_punct]
    t = depuncture_t(body, index)
    out[:, :, col0:col0 + t.shape[-1]] = t
    return buf[..., -15:, :].clone()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_equals_old_composition(dtype):
    """The twin equals the composition the step ran before, and its slice
    view equals subch_cif_slices, on the UEP profile with padding."""
    layout, port_profile, _ = GROUPS["uep128_pl3"]
    profile, padding = port_profile()
    soft, carries = inputs(3, 8, layout, dtype, seed=4)
    got, new = port_chain(soft, carries, layout, profile, padding, 3, 8, dtype,
                          deinterleave_depuncture_t_ref)
    cfg = SubchannelConfig(1, layout[0][0], layout[0][1], profile, padding)
    old = lambda *a: old_composition(*a, cfg=cfg)
    want, want_new = port_chain(soft, carries, layout, profile, padding, 3, 8, dtype, old)
    assert torch.equal(got, want) and torch.equal(new[0], want_new[0])
    st = as_torch(soft, dtype)
    rows = SoftRows.cif_slices(DAB.nb_fic_bits, DAB.nb_cifs, cfg.start_cu * CU_BITS,
                               cfg.slice_bits)
    assert torch.equal(rows.view(st), subch_cif_slices(st, cfg, DAB.nb_fic_bits, DAB.nb_cifs))


def test_chain_refuses_bad_shapes():
    """A carry of another width or dtype, or an output too narrow, raises."""
    index = torch.from_numpy(depuncture_index(eep_profile(24, 3, 0)))
    soft = torch.zeros((2, DAB.nb_frame_bits))
    rows = SoftRows.cif_slices(DAB.nb_fic_bits, DAB.nb_cifs, 0, 24 * CU_BITS)
    out = torch.zeros((index.shape[0] // 8, 8, 8))
    with pytest.raises(ValueError):
        deinterleave_depuncture_t(soft, rows, torch.zeros((15, 23 * CU_BITS)), index,
                                  24 * CU_BITS, out)
    with pytest.raises(ValueError):
        deinterleave_depuncture_t(soft, rows, torch.zeros((15, 24 * CU_BITS),
                                                          dtype=torch.bfloat16),
                                  index, 24 * CU_BITS, out)
    with pytest.raises(ValueError):
        deinterleave_depuncture_t(soft, rows, torch.zeros((15, 24 * CU_BITS)), index,
                                  24 * CU_BITS, out, col0=1)
