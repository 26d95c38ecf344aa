"""Port parity for the small host modules and the command lines: pipe_asdf,
taskfarm, profiling, the msum API of menv, partition_parallel, the public
helpers of population, ic_fields, tools_cv and zenbu_window, and the
``_cli`` parsers of prepare_sim and the four ZCV mains, each against the
JAX package on the same inputs.

Tolerances: exact (bytes, status records, parsed arguments, index arrays
and float64 sums over the same neighbour lists); the IC field helpers at
rtol 1e-5 of the field's largest value (f32 FFTs in other libraries, the
budget of tests/test_torch_zcv.py's fields).
"""

import argparse
import io
import os
import runpy
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu_torch.config import DEFAULT_CONFIG
from abacusutils_tpu_torch.io import pipe_asdf as tpipe_asdf
from abacusutils_tpu_torch.models.hod import menv as tmenv
from abacusutils_tpu_torch.models.hod import population as tpop
from abacusutils_tpu_torch.models.zcv import ic_fields as tic
from abacusutils_tpu_torch.models.zcv import tools_cv as ttools
from abacusutils_tpu_torch.models.zcv import zenbu_window as tzw
from abacusutils_tpu_torch.ops import grid as tgrid
from abacusutils_tpu_torch.testing import synthetic_compaso, write_compaso_sim
from abacusutils_tpu_torch.utils import profiling, taskfarm as ttaskfarm

REPO = Path(__file__).resolve().parent.parent
FIELD_RTOL = 1e-5


# ---- pipe_asdf ---------------------------------------------------------------


@pytest.fixture(scope='module')
def halo_files(tmp_path_factory):
    """Two halo_info files of a synthetic catalog, written by JAX's writer."""
    from abacusutils_tpu.io.asdf_file import write_asdf as jax_write_asdf

    root = tmp_path_factory.mktemp('pipe')
    sim = synthetic_compaso(2, 600, 2000, 100, seed=3)
    info = write_compaso_sim(root, sim, writer=jax_write_asdf)
    return sorted(f for f in info['files'] if f.parent.name == 'halo_info')


class _Sink(io.BytesIO):
    """A pipe that keeps what was written when it is closed."""

    def close(self):
        self.data = self.getvalue()
        super().close()


def _stream(unpack, fns, fields):
    sink = _Sink()
    unpack([str(f) for f in fns], fields, pipe=sink, verbose=False)
    return sink.data


def test_pipe_asdf_stream_matches_jax(halo_files):
    from abacusutils_tpu.io import pipe_asdf as jpipe_asdf

    fields = ['N', 'x_L2com', 'r100_L2com']
    got = _stream(tpipe_asdf.unpack_to_pipe, halo_files, fields)
    assert got == _stream(jpipe_asdf.unpack_to_pipe, halo_files, fields)
    n = np.frombuffer(got[:8], np.int64)[0]
    assert np.frombuffer(got[8:12], np.int32)[0] == 4 and n > 0
    with pytest.raises(ValueError, match='not found'):
        _stream(tpipe_asdf.unpack_to_pipe, halo_files, ['no_such_field'])


def test_pipe_client_prints_the_same_lines(halo_files, tmp_path):
    """native/pipe_client, built with gcc, reads both packages' streams of
    N and a float32 triple column and prints the same lines."""
    client = tmp_path / 'client'
    subprocess.run(['gcc', '-O2', '-o', str(client), str(REPO / 'native/pipe_client/client.c')],
                   check=True)
    outs = []
    for mod in ('abacusutils_tpu_torch.io.pipe_asdf', 'abacusutils_tpu.io.pipe_asdf'):
        src = subprocess.Popen([sys.executable, '-m', mod, '-f', 'N', '-f', 'x_L2com',
                                *map(str, halo_files)], cwd=REPO, stdout=subprocess.PIPE,
                               stderr=subprocess.DEVNULL)
        res = subprocess.run([str(client)], stdin=src.stdout, capture_output=True, text=True,
                             timeout=120)
        src.stdout.close()
        assert src.wait(timeout=120) == 0 and res.returncode == 0, res.stderr
        outs.append(res.stdout)
    assert outs[0] == outs[1] and outs[0].count('\n') == 22


# ---- taskfarm ----------------------------------------------------------------


TASKS = """# a sweep
#FARM PREFIX echo run
 one
 two
#FARM PREFIX
exit 3
#FARM BARRIER
#FARM REPEAT 3 start 5 echo rep $TASKFARM_REPEAT_INDEX
#DISBATCH SUFFIX  > /dev/null
echo last
"""


def _records(path):
    """Status lines without the elapsed time, host and pid."""
    out = []
    for line in Path(path).read_text().splitlines():
        taskid, flag, rc, _, _, _, cmd = line.split('\t', 6)
        out.append((int(taskid), flag, int(rc), cmd))
    return sorted(out)


def _farm_runs(tf_mod, tmp):
    taskfile = tmp / 'tasks.txt'
    taskfile.write_text(TASKS)
    claims = tmp / 'claims'
    first = tf_mod.farm(str(taskfile), workers=2, status_path=str(tmp / 's1'),
                        shared=str(claims))
    # a second farmer on the same claims file finds every task claimed
    second = tf_mod.farm(str(taskfile), workers=2, status_path=str(tmp / 's2'),
                         shared=str(claims))
    # resume: the failure is re-run with -R, the rest skipped
    resumed = tf_mod.farm(str(taskfile), workers=2, status_path=str(tmp / 's3'),
                          resume_from=str(tmp / 's1'), retry=True)
    # a crashed farmer's claim released: drop task 0's record and claim it anew
    lines = (tmp / 's1').read_text().splitlines()
    (tmp / 's4').write_text(''.join(ln + '\n' for ln in lines if not ln.startswith('0\t')))
    released = tf_mod.farm(str(taskfile), workers=1, status_path=str(tmp / 's4'),
                           shared=str(claims), release_stale=True)
    counts = [(r.ran, r.failed, r.skipped, sorted(r.failed_ids))
              for r in (first, second, resumed, released)]
    return counts, [_records(tmp / f's{i}') for i in range(1, 5)]


def test_taskfarm_matches_jax(tmp_path):
    from abacusutils_tpu.utils import taskfarm as jtaskfarm

    (tmp_path / 'p').mkdir()
    (tmp_path / 'j').mkdir()
    got = _farm_runs(ttaskfarm, tmp_path / 'p')
    ref = _farm_runs(jtaskfarm, tmp_path / 'j')
    assert got == ref
    counts, records = got
    assert counts[0] == (7, 1, 0, [2]) and counts[1] == (0, 0, 0, [])
    assert counts[2] == (1, 1, 6, [2]) and counts[3][0] == 1
    assert records[0][3][1] == 'B' and records[0][4][3] == 'echo rep $TASKFARM_REPEAT_INDEX'


def test_taskfarm_runs_as_a_module(tmp_path):
    taskfile = tmp_path / 'tasks.txt'
    taskfile.write_text('echo $TASKFARM_TASKID > out_$TASKFARM_TASKID\n' * 2)
    res = subprocess.run([sys.executable, '-m', 'abacusutils_tpu_torch.utils.taskfarm',
                          str(taskfile), '-w', '2'], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr
    assert '2 ran, 0 failed' in res.stderr and (tmp_path / 'out_1').read_text() == '1\n'


# ---- profiling ---------------------------------------------------------------


def test_stage_timer_and_device_trace_on_cpu(tmp_path):
    t = profiling.Timings()
    with profiling.stage_timer('mm', t, device='cpu'):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with profiling.stage_timer('mm', t):
        pass
    assert list(t) == ['mm'] and t['mm'] > 0 and 'total' in str(t)
    with profiling.device_trace(tmp_path / 'trace') as fn:
        torch.ones(128, 128) @ torch.ones(128, 128)
    text = Path(fn).read_text()
    assert Path(fn).parent == tmp_path / 'trace' and 'aten::mm' in text


# ---- menv, partition_parallel -----------------------------------------------


def test_msum_api_matches_jax():
    from scipy.spatial import KDTree

    from abacusutils_tpu.models.hod import menv as jmenv

    rng = np.random.default_rng(4)
    pos = rng.random((3000, 3)) * 100
    mass = 10 ** (11 + 3 * rng.random(3000))
    tree = KDTree(pos, boxsize=100.0)
    r = rng.uniform(2, 6, 3000)
    for mod in (tmenv, jmenv):
        assert hasattr(mod, 'msum_in_batches')
    got = tmenv.msum_in_batches(np.zeros(3000), pos, mass, r, tree, 1, sign=-1, batch_size=700)
    ref = jmenv.msum_in_batches(np.zeros(3000), pos, mass, r, tree, 1, sign=-1, batch_size=700)
    npt.assert_array_equal(got, ref)
    for a, b in zip(tmenv.query_inds(pos[:50], 4.0, tree, 1), jmenv.query_inds(pos[:50], 4.0,
                                                                                tree, 1)):
        npt.assert_array_equal(a, b)
    flat, starts = tmenv.concat_to_arr([[3, 1], [], [7]])
    npt.assert_array_equal(flat, [3, 1, 7])
    npt.assert_array_equal(starts, [0, 2, 2, 3])
    inds, st = jmenv.query_inds(pos[:20], 5.0, tree, 1)
    npt.assert_array_equal(tmenv.msum_core(np.ones(20), mass, inds, st, 2.0),
                           jmenv.msum_core(np.ones(20), mass, inds, st, 2.0))
    npt.assert_array_equal(tmenv.msum_batch(np.zeros(20), pos[:20], mass, 5.0, tree, 1, 1),
                           jmenv.msum_batch(np.zeros(20), pos[:20], mass, 5.0, tree, 1, 1))


@pytest.mark.parametrize('sort', [False, True])
@pytest.mark.parametrize('weighted', [False, True])
def test_partition_parallel_matches_jax(sort, weighted):
    from abacusutils_tpu.ops import grid as jgrid

    rng = np.random.default_rng(5)
    pos = (rng.random((5000, 3)) * 250).astype(np.float32)
    pos[:10, 1] = 250.0  # on the box edge: the last stripe
    w = rng.random(5000).astype(np.float32) if weighted else None
    got = tgrid.partition_parallel(pos, 7, 250.0, w, coord=1, sort=sort)
    ref = jgrid.partition_parallel(pos, 7, 250.0, None if w is None else w.copy(), coord=1,
                                   sort=sort)
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            npt.assert_array_equal(a, b)
    assert got[1][-1] == 5000


# ---- the remaining public names ----------------------------------------------


def test_compute_cent_keep_matches_jax():
    from abacusutils_tpu.models.hod import population as jpop
    from torch_helpers import TRACERS

    rng = np.random.default_rng(6)
    n = 4000
    pos = rng.uniform(-250, 250, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 300, (n, 3)).astype(np.float32)
    mass = (10 ** (11 + 4 * rng.random(n))).astype(np.float32)
    args = (pos, vel, mass, np.arange(n), np.ones(n, np.float32),
            rng.random(n).astype(np.float32), rng.normal(0, 100, (n, 3)).astype(np.float32),
            np.zeros(n, np.float32), np.zeros(n, np.float32), np.zeros(n, np.float32))
    want = ('LRG', 'ELG', 'QSO')
    tp = jpop.prepare_tracer_params({k: dict(TRACERS[k]) for k in want}, 0.5)
    got = tpop.compute_cent_keep(*args, tp, True, 0.01, 500.0, want, device='cpu')
    ref = np.asarray(jpop.compute_cent_keep(*args, tp, True, 0.01, 500.0, want))
    assert got.dtype == np.int8 and (got > 0).sum() > 100
    npt.assert_array_equal(got, ref)


def test_ic_field_helpers_match_jax():
    from abacusutils_tpu.models.zcv import ic_fields as jic

    n, lbox = 16, 200.0
    rng = np.random.default_rng(7)
    delta_k = np.fft.rfftn(rng.normal(0, 1, (n,) * 3).astype(np.float32)).astype(np.complex64)
    for name in ('get_dk_to_s2', 'get_dk_to_n2'):
        got = getattr(tic, name)(delta_k, n, lbox, device='cpu')
        ref = np.asarray(getattr(jic, name)(delta_k, n, lbox))
        assert got.dtype == torch.float32 and got.shape == (n,) * 3
        npt.assert_allclose(got.numpy(), ref, rtol=0, atol=FIELD_RTOL * np.abs(ref).max(),
                            err_msg=name)
    a = rng.random((4, 4)).astype(np.float32)
    b = rng.random((4, 4)).astype(np.float32)
    got = tic.add_ij(torch.from_numpy(a.copy()), torch.from_numpy(b), 4, 2.0)
    npt.assert_array_equal(got.numpy(), jic.add_ij(a.copy(), b, 4, 2.0))
    npt.assert_array_equal(tic.add_ij(a.copy(), b, 4, 3.0), jic.add_ij(a.copy(), b, 4, 3.0))


def test_get_cfg_and_meshgrid_match_jax():
    from abacusutils_tpu.models.zcv import tools_cv as jtools
    from abacusutils_tpu.models.zcv import zenbu_window as jzw

    sim = 'AbacusSummit_base_c000_ph000'
    assert ttools.get_cfg(sim, 0.5, 64) == jtools.get_cfg(sim, 0.5, 64)
    x, y, z = np.arange(3.0), np.arange(3.0) + 10, np.arange(3.0) + 20
    for a, b in zip(tzw.meshgrid(x, y, z), jzw.meshgrid(x, y, z)):
        npt.assert_array_equal(a, b)


# ---- the command lines -------------------------------------------------------


class _Parsed(Exception):
    pass


@pytest.fixture
def parsed(monkeypatch):
    """Each parse_args raises _Parsed with the parsed keyword arguments, so a
    command line is read and its main never runs."""
    real = argparse.ArgumentParser.parse_args

    def parse_args(self, args=None, namespace=None):
        raise _Parsed(vars(real(self, args, namespace)))

    monkeypatch.setattr(argparse.ArgumentParser, 'parse_args', parse_args)

    def run(fn):
        with pytest.raises(_Parsed) as e:
            fn()
        return e.value.args[0]

    return run


def _jax_main_block(monkeypatch, module, argv):
    """A runner of the JAX module's __main__ block on `argv` (the module is
    imported already: runpy's warning of that is expected)."""
    monkeypatch.setattr(sys, 'argv', [module, *argv])

    def run():
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', RuntimeWarning)
            runpy.run_module(module, run_name='__main__')

    return run


ARGVS = {
    'models.hod.prepare_sim': [[], ['--path2config', 'c.json', '--alt_simname', 'X', '--alt_z',
                                    '0.8', '--newseed', '7', '--overwrite', '0', '--halo_lc']],
    'models.zcv.ic_fields': [[], ['--path2config', 'c.json', '--alt_simname', 'X', '--verbose']],
    'models.zcv.advect_fields': [[], ['--path2config', 'c.json', '--want_rsd', '--alt_simname',
                                      'X', '--save_3D_power', '--only_requested_fields']],
    'models.zcv.linear_fields': [[], ['--path2config', 'c.json', '--save_3D_power']],
    'models.zcv.zenbu_window': [[], ['--path2config', 'c.json', '--alt_simname', 'X',
                                     '--want_xi']],
}


@pytest.mark.parametrize('mod', list(ARGVS))
def test_cli_parses_as_jax(mod, parsed, monkeypatch):
    """Each port _cli parses an argv to the keyword arguments of JAX's parser
    on the same argv, apart from the default config's suffix (.json for
    .yaml) and the port's --device."""
    import importlib

    port = importlib.import_module(f'abacusutils_tpu_torch.{mod}')
    jax_mod = importlib.import_module(f'abacusutils_tpu.{mod}')
    for argv in ARGVS[mod]:
        got = parsed(lambda: port._cli(argv))
        if hasattr(jax_mod, '_cli'):
            ref = parsed(lambda: jax_mod._cli(argv))
        else:
            ref = parsed(_jax_main_block(monkeypatch, f'abacusutils_tpu.{mod}', argv))
        assert got.pop('device') is None
        if not argv:
            assert got['path2config'] == DEFAULT_CONFIG
            assert ref['path2config'] == DEFAULT_CONFIG.replace('.json', '.yaml')
            got['path2config'] = ref['path2config']
        assert got == ref
    assert parsed(lambda: port._cli(['--device', 'cpu']))['device'] == 'cpu'


def test_prepare_sim_help_without_jax():
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['abacusutils_tpu'] = None\n"
            "sys.argv = ['prepare_sim', '--help']\n"
            "runpy.run_module('abacusutils_tpu_torch.models.hod.prepare_sim', "
            "run_name='__main__')\n")
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in ('--path2config', '--alt_simname', '--alt_z', '--newseed', '--overwrite',
                 '--halo_lc', '--device', 'config/abacus_hod.json'):
        assert flag in res.stdout
