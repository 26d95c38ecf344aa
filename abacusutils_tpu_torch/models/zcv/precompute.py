r"""The ZCV precompute as arrays in and arrays out: what the JAX package's
ic_fields, advect_fields and zenbu_window ``main``s write into ``zcv_dir``,
held in memory for :func:`apply.apply_zcv`."""

from dataclasses import dataclass, field

import numpy as np

from .advect_fields import advected_field_ffts, power_ij
from .cosmo import growth_from_meta
from .ic_fields import gaussian_filter, get_fields
from .zenbu_window import window_and_templates

__all__ = ['ZCVProducts', 'zcv_products']


@dataclass
class ZCVProducts:
    """The products of one simulation, redshift and zcv setting.

    field_ffts: {want_rsd: {field name: rfft mesh}}, the advected fields
    (advected_field_ffts); pk_ij: {want_rsd: pk_ij_dict} (power_ij);
    window, keff, k_binc, kcut: the window matrix and its binning;
    templates: {want_rsd: pk_ij_zenbu}; meta: the cosmo.get_meta dict at
    z_mock; tracer_spectra: {(tracer tag, want_rsd): pk_tr_dict}, filled by
    apply_zcv ('' is the tag of a single tracer) and read back with
    load_presaved=True."""

    field_ffts: dict
    pk_ij: dict
    window: np.ndarray
    keff: np.ndarray
    k_binc: np.ndarray
    kcut: float
    templates: dict
    meta: dict
    tracer_spectra: dict = field(default_factory=dict)


def zcv_products(delta_lin, disp, Lbox, nmesh, config, meta, filter_ic=True, engine='auto',
                 device=None):
    """Run the ZCV precompute on arrays: the IC bias fields
    (ic_fields.get_fields), their Zel'dovich advection and spectra in RSD
    and real space (real space only when config's want_rsd is False), and
    the window and templates (zenbu_window.window_and_templates).

    delta_lin: the (nmesh,)*3 linear IC density; disp: (disp_x, disp_y,
    disp_z), its displacement in units of the box (load_disp's units);
    filter_ic: apply the Gaussian filter of kcut to both first, as
    ic_fields.main does (False: they are already the filtered fields of
    ``ic_filt_nmesh*.asdf``); meta: the cosmo.get_meta dict at z_mock.
    numpy inputs go to `device` (the card when None); `engine` goes to
    window_and_templates. Returns :class:`ZCVProducts`."""
    zp, pp = config['zcv_params'], config['power_params']
    kcut = zp['kcut']
    z_this = config['sim_params']['z_mock']
    want_rsd = config['HOD_params']['want_rsd']
    if not np.isclose(Lbox, meta['BoxSize']):
        raise ValueError(f'Lbox {Lbox} is not the simulation\'s BoxSize {meta["BoxSize"]}')
    if filter_ic:
        delta_lin = gaussian_filter(delta_lin, nmesh, Lbox, kcut, device)
        disp = [gaussian_filter(d, nmesh, Lbox, kcut, delta_lin.device) for d in disp]
    fields = get_fields(delta_lin, Lbox, nmesh, device)
    del delta_lin
    field_ffts, pk_ij = {}, {}
    for rsd in ((True, False) if want_rsd else (False,)):
        D, f_growth = growth_from_meta(meta, z_this, want_rsd=rsd)
        field_ffts[rsd] = advected_field_ffts(disp, fields, Lbox, nmesh, D, f_growth, pp,
                                              fields[0].device)
        pk_ij[rsd] = power_ij(field_ffts[rsd], Lbox, pp, D)
    del fields
    wt = window_and_templates(nmesh, Lbox, pp, kcut, z_this, meta, want_rsd, engine,
                              field_ffts[False]['1cb'].device)
    templates = {False: wt['pk_ij_zenbu']}
    if want_rsd:
        templates[True] = wt['pk_ij_zenbu_rsd']
    return ZCVProducts(field_ffts, pk_ij, wt['window'], wt['keff'], wt['k_binc'], kcut,
                       templates, meta)
