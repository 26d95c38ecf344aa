r"""The ZCV and LCV precomputes as arrays in and arrays out: what the JAX
package's ic_fields, advect_fields, linear_fields and zenbu_window
``main``s write into ``zcv_dir`` / ``lcv_dir``, held in memory for
:func:`apply.apply_zcv`, :func:`apply.apply_zcv_xi` and the LCV flows of
tools_cv: computed from arrays (:func:`zcv_products`, :func:`lcv_products`)
or read from the files of those ``main``s (``ZCVProducts.from_dir``,
``LCVProducts.from_dir``)."""

from dataclasses import dataclass, field

import numpy as np

from ...config import load_config
from ...convert import resolve_device
from ...io.asdf_file import open_asdf
from ...metadata import get_meta
from ...ops.power import get_k_mu_edges
from .advect_fields import advected_field_ffts, power_ij
from .cosmo import growth_from_meta
from .files import k_tag, read_data, read_fft, read_header, sim_dirs
from .ic_fields import gaussian_filter, get_fields
from .linear_fields import linear_fields
from .zenbu_window import periodic_window_function, window_and_templates

__all__ = ['ZCVProducts', 'zcv_products', 'LCVProducts', 'lcv_products']


@dataclass
class ZCVProducts:
    """The products of one simulation, redshift and zcv setting.

    field_ffts: {want_rsd: {field name: rfft mesh}}, the advected fields
    (advected_field_ffts); pk_ij: {want_rsd: pk_ij_dict} (power_ij);
    window, keff, k_binc, kcut: the window matrix and its binning;
    templates: {want_rsd: pk_ij_zenbu}; meta: the cosmo.get_meta dict at
    z_mock; tracer_spectra: {(tracer tag, want_rsd): pk_tr_dict}, filled by
    apply_zcv ('' is the tag of a single tracer) and read back with
    load_presaved=True; tracer_ffts: {want_rsd: the tracer's Fourier field},
    filled by apply_zcv_xi and read back with load_presaved=True."""

    field_ffts: dict
    pk_ij: dict
    window: np.ndarray
    keff: np.ndarray
    k_binc: np.ndarray
    kcut: float
    templates: dict
    meta: dict
    tracer_spectra: dict = field(default_factory=dict)
    tracer_ffts: dict = field(default_factory=dict)
    config: dict = None

    @classmethod
    def from_dir(cls, config, field_level=False, device=None):
        """The products advect_fields.main and zenbu_window.main wrote under
        config's zcv_dir: the advected Fourier fields of zcv_params' fields
        (on `device`, the card when None) and their P_ij tables in RSD and
        real space (real space only when want_rsd is False), the window and
        the templates, each file's kcut and k bins checked against the
        config as apply.py checks them (apply.py:_check_kcut, _load).
        field_level: the nmesh / 2 linear bins to the Nyquist k of
        apply_zcv_xi (whose P_ij tables are not read). The config is kept,
        so apply_zcv can write and read the tracer's files."""
        config = load_config(config)
        zp, pp = config['zcv_params'], config['power_params']
        nmesh, kcut = zp['nmesh'], zp['kcut']
        sim_name, z_this = config['sim_params']['sim_name'], config['sim_params']['z_mock']
        meta = get_meta(sim_name, redshift=z_this)
        Lbox = meta['BoxSize']
        if field_level:
            kmax, nk, nmu, logk = np.pi * nmesh / Lbox, nmesh // 2, 1, False
        else:
            kmax, nk, nmu, logk = pp['k_hMpc_max'], pp['nbins_k'], pp['nbins_mu'], pp['logk']
        k_bins, mu_bins = get_k_mu_edges(Lbox, kmax, nk, nmu, logk)
        k_binc = 0.5 * (k_bins[1:] + k_bins[:-1])
        mu_binc = 0.5 * (mu_bins[1:] + mu_bins[:-1])
        tag = k_tag(Lbox, nmesh, kmax, nk, nmu, logk)
        save_dir, save_z_dir = sim_dirs(zp['zcv_dir'], sim_name, z_this)
        spaces = (True, False) if config['HOD_params']['want_rsd'] else (False,)
        dev = resolve_device(device)

        def checked(fn):
            _check_kcut(fn, kcut)
            return fn

        field_ffts, pk_ij, templates = {}, {}, {}
        for rsd in spaces:
            rsd_str = '_rsd' if rsd else ''
            field_ffts[rsd] = {
                kn: read_fft(checked(save_z_dir / f'advected_{kn}_field{rsd_str}_fft_nmesh'
                                                  f'{nmesh:d}.asdf'), kn, dev)
                for kn in zp['fields']}
            if not field_level:
                fn = checked(save_z_dir / f'power{rsd_str}_ij_{tag}.asdf')
                pk_ij[rsd] = read_data(fn)
                assert np.allclose(k_binc, pk_ij[rsd]['k_binc']), f'Mismatching file: {fn}'
                assert np.allclose(mu_binc, pk_ij[rsd]['mu_binc']), f'Mismatching file: {fn}'
            fn = save_z_dir / f'zenbu_pk{rsd_str}_ij_lpt_{tag}.npz'
            with np.load(fn) as data:
                assert np.allclose(data['k_binc'], k_binc), f'Mismatching file: {fn}'
                assert np.isclose(data['kcut'], kcut), f'Mismatching file: {fn}'
                templates[rsd] = data['pk_ij_zenbu']
        with np.load(save_dir / f'window_{tag}.npz') as data:
            window, keff = data['window'], data['keff']
        return cls(field_ffts, pk_ij, window, keff, k_binc, kcut, templates, meta, config=config)


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


@dataclass
class LCVProducts:
    """The LCV products of one simulation, redshift and lcv setting.

    field_ffts: {'delta', 'deltamu2'}, the linear Fourier fields
    (linear_fields.linear_field_ffts); pk_lin: their pk_lin_dict
    (linear_fields.power_lin); window, keff, k_binc, kcut: the window
    matrix at the power_params k bins and its binning; meta: the
    cosmo.get_meta dict at z_mock."""

    field_ffts: dict
    pk_lin: dict
    window: np.ndarray
    keff: np.ndarray
    k_binc: np.ndarray
    kcut: float
    meta: dict

    @classmethod
    def from_dir(cls, config, device=None):
        """The LCV products of the files under config's lcv_dir: the linear
        Fourier fields of ``ic_filt_nmesh{n}.asdf`` (on `device`, the card
        when None; the JAX package's LCV flows compute them from that file
        too), the pk_lin table of linear_fields.main and the window
        ``window_<k tag>.npz`` of zenbu_window.main, the kcut and k bins
        checked against the config. A missing window is computed
        (zenbu_window.periodic_window_function) and saved there."""
        from .linear_fields import linear_field_ffts

        config = load_config(config)
        lp, pp = config['lcv_params'], config['power_params']
        nmesh, kcut = lp['nmesh'], lp['kcut']
        sim_name, z_this = config['sim_params']['sim_name'], config['sim_params']['z_mock']
        meta = get_meta(sim_name, redshift=z_this)
        Lbox = meta['BoxSize']
        k_bins, mu_bins = get_k_mu_edges(Lbox, pp['k_hMpc_max'], pp['nbins_k'], pp['nbins_mu'],
                                         pp['logk'])
        k_binc = 0.5 * (k_bins[1:] + k_bins[:-1])
        tag = k_tag(Lbox, nmesh, pp['k_hMpc_max'], pp['nbins_k'], pp['nbins_mu'], pp['logk'])
        save_dir, _ = sim_dirs(lp['lcv_dir'], sim_name, z_this)
        ic_fn = save_dir / f'ic_filt_nmesh{nmesh:d}.asdf'
        _check_kcut(ic_fn, kcut)
        with open_asdf(ic_fn) as f:
            dens = np.asarray(f['data']['dens'])
        field_ffts = linear_field_ffts(dens, nmesh, resolve_device(device))
        fn = save_dir / f'power_lin_{tag}.asdf'
        _check_kcut(fn, kcut)
        pk_lin = read_data(fn)
        assert np.allclose(k_binc, pk_lin['k_binc']), f'Mismatching file: {fn}'
        window_fn = save_dir / f'window_{tag}.npz'
        if not window_fn.exists():
            # the LCV chain has no main that writes it: made here, once
            window, keff = periodic_window_function(nmesh, Lbox, k_bins, k_binc, k2weight=True,
                                                    device=field_ffts['delta'].device)
            np.savez(window_fn, window=window, keff=keff)
        with np.load(window_fn) as data:
            window, keff = data['window'], data['keff']
        return cls(field_ffts, pk_lin, window, keff, k_binc, kcut, meta)


def lcv_products(delta_lin, Lbox, nmesh, config, meta, filter_ic=True, engine='auto',
                 device=None):
    """Run the LCV precompute on arrays: the linear fields and their spectra
    (linear_fields.linear_fields) and the window of the power_params k bins
    at their centres (zenbu_window.periodic_window_function, `engine`: K8
    over its row plan on the card with 'device', the default from nmesh
    256).

    delta_lin: the (nmesh,)*3 linear IC density; filter_ic: apply the
    Gaussian filter of lcv_params' kcut first, as ic_fields.main does
    (False: it is already the filtered density of ``ic_filt_nmesh*.asdf``);
    meta: the cosmo.get_meta dict at z_mock. numpy input goes to `device`
    (the card when None). Returns :class:`LCVProducts`."""
    lp, pp = config['lcv_params'], config['power_params']
    kcut = lp['kcut']
    if not np.isclose(Lbox, meta['BoxSize']):
        raise ValueError(f'Lbox {Lbox} is not the simulation\'s BoxSize {meta["BoxSize"]}')
    if filter_ic:
        delta_lin = gaussian_filter(delta_lin, nmesh, Lbox, kcut, device)
    pk_lin, field_ffts = linear_fields(delta_lin, Lbox, nmesh, pp, device)
    del delta_lin
    k_bins, _ = get_k_mu_edges(Lbox, pp['k_hMpc_max'], pp['nbins_k'], pp['nbins_mu'], pp['logk'])
    k_binc = 0.5 * (k_bins[1:] + k_bins[:-1])
    window, keff = periodic_window_function(nmesh, Lbox, k_bins, k_binc, k2weight=True,
                                            engine=engine, device=field_ffts['delta'].device)
    return LCVProducts(field_ffts, pk_lin, window, keff, k_binc, kcut, meta)


def _check_kcut(fn, kcut):
    """A file's header kcut must be `kcut` (apply.py:_check_kcut; a missing
    file raises when it is read)."""
    try:
        assert np.isclose(read_header(fn)['kcut'], kcut), f'Mismatching file: {fn}'
    except FileNotFoundError:
        pass
