#!/usr/bin/env python3
"""Gaussian likelihood of HOD clustering against data vectors (the
counterpart of scripts/hod/likelihood.py): the data's paths come from the
config's ``data_params`` section, each an ``.npz`` (or ``.npy``) file."""

import numpy as np


class Data:
    """The observed clustering vectors and inverse covariances per tracer
    combination (``data_params['tracer_combos'][combo]['path2power']`` and
    ``['path2cov']``)."""

    def __init__(self, data_params, HOD_params):
        self.power = {}
        self.icov = {}
        for combo, paths in data_params['tracer_combos'].items():
            d = np.load(paths['path2power'])
            self.power[combo] = d[list(d.keys())[0]].flatten()
            c = np.load(paths['path2cov'])
            cov = c[list(c.keys())[0]]
            self.icov[combo] = np.linalg.inv(cov)

    def compute_likelihood(self, theory_clustering):
        """-chi^2 / 2 summed over the combinations of the data."""
        lnprob = 0.0
        for combo, target in self.power.items():
            delta = target - theory_clustering[combo].flatten()
            lnprob += -0.5 * delta @ self.icov[combo] @ delta
        return lnprob
