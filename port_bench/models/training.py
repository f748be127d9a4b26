"""A training cell's session: one model object, driven through ``fit``.

Set-up builds the model from the seed, drives it through the first three
steps by two ``fit`` calls on rows that all differ (one batch, then two;
epochs 1 and 2), keeping a host copy of its state after each, then runs
a warm-up through the same call on the whole data.  The window is one
more ``fit`` call on the whole data, of as many epochs as fill the
window at the cell's nominal seconds an epoch, rounded to the period of
the epoch-cadenced metrics, so that every run of a cell does the same
work and every window holds the same mix of epochs.  A traced window runs
the same epochs as pieces, a slice of each traced (``traced_window``).
After the window, the late check's steps continue from the state the
window left: one ``fit`` call a step, on rows that all differ, a full
batch and then the epoch's remainder batch where it has one.
Checkpoints are written at the end of each ``fit`` only, into a directory
of the run's own.
"""

import time

import numpy as np
import torch

from ..harness.data import make_rows, sub_seed
from ..reference import common

DATA_SEED, WEIGHT_SEED, MODEL_SEED = 1, 2, 3
#: pieces a traced window is cut into, and the launches the traced slices
#: may hold together, so that they sample the whole window's mix of epochs
#: and the profiler's buffers keep every record
TRACE_PIECES, TRACED_LAUNCHES = 8, 1000000


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def trace_plan(epochs, period, launches_per_epoch):
    """(untraced, timed, traced) epochs of each piece of a traced window of
    `epochs` epochs (a multiple of `period`): up to TRACE_PIECES pieces of
    at least two whole periods, each an untraced part, then a part timed
    without the profiler and a traced slice of as many epochs, so that the
    timed part gives the slice's length without the profiler, a fit call's
    own cost included alike; the slices' launches together about
    TRACED_LAUNCHES at most.  A window of one period is one traced
    slice."""
    periods = epochs // period
    if periods < 2:
        return [(0, 0, epochs)]
    n = min(TRACE_PIECES, periods // 2)
    share = min(1., TRACED_LAUNCHES / max(launches_per_epoch * epochs, 1))
    plan = []
    for i in range(n):
        length = periods // n + (i < periods % n)
        traced = min(length // 2, max(1, int(share * length)))
        plan.append(((length - 2 * traced) * period, traced * period,
                     traced * period))
    return plan


class FitSession(object):
    """A training cell's session.  The runner drives any family's session
    through the same calls: ``prepare()``, ``units(seconds, workload)``,
    ``window(units)`` or ``traced_window(units, plan(units), traced)``,
    ``describe(window)``, ``after_window()``, ``end_to_end(window, wall)``
    or ``traced_context(window)``, ``free()`` and ``judge(reference,
    device)``.

    Subclasses set ``model``, ``period`` (the epochs after which the
    epoch-cadenced metrics repeat) and ``metrics_every`` (the steps between
    logged train metrics) in ``build``, map the reference's state names to
    the model's arrays in ``STATE``, and give ``counters()``,
    ``work_of_step(rows, window)`` and ``inputs()``; their modules give
    ``KERNEL_OF_COUNTER``."""

    def __init__(self, config, traffic, seed, device, workdir):
        self.config, self.traffic = config, traffic
        self.device, self.workdir = device, workdir
        self.B = int(traffic['batch_size'])
        data = config['data']
        n_train, n_val = int(data['n_train']), int(data['n_val'])
        rows = make_rows(n_train + n_val, data, sub_seed(seed, DATA_SEED),
                         device)
        self.X = rows[:n_train].cpu().numpy()
        self.X_val = rows[n_train:].cpu().numpy()
        del rows
        self.model_seed = sub_seed(seed, MODEL_SEED)
        # what the session has asked of the model: fit calls, epochs and
        # steps, from which the reference keys its draws
        self.fits = self.epochs_done = self.steps_done = 0
        self.build(sub_seed(seed, WEIGHT_SEED))

    # ---- what the runner calls ------------------------------------------
    def prepare(self):
        """The set-up after the model is built: the first steps, whose
        states the check judges, and the warm-up.  Returns a line that
        says what it did."""
        self.first = self.first_steps()
        c0 = sum(self.counters().values())
        epoch_s, warm = self.warm()
        self.launches_per_epoch = (sum(self.counters().values()) - c0) // \
            warm
        return 'set-up: warm-up of {0} epochs, {1:.6f} s and {2} launches ' \
            'an epoch'.format(warm, epoch_s, self.launches_per_epoch)

    def units(self, seconds, workload):
        """The window's epochs at the workload's nominal seconds an
        epoch."""
        return self.epochs_for(seconds, workload['epoch_seconds'])

    def plan(self, epochs):
        return trace_plan(epochs, self.period, self.launches_per_epoch)

    def traced(self, fn, capture):
        """`capture(fn)` of a traced slice, its record given the port's
        launch counts over it."""
        c = self.counters()
        record, trace = capture(fn)
        after = self.counters()
        record['launches'] = {k: after[k] - c.get(k, 0) for k in after}
        return record, trace

    def describe(self, window):
        """Lines that say what the window did (none here)."""
        return []

    def after_window(self):
        """The program's part of the checks after the window: the late
        steps, and the inputs the reference needs."""
        self.pre, self.late = self.late_steps()
        self.inputs_ = self.inputs()

    def traced_context(self, window):
        """(what the traced slices did: epochs, steps, rows, and
        ``untraced_s``, the seconds they take without the profiler, from
        the timed parts beside them, None where a piece has none; the
        port's launches over them; the work of their steps by kernel
        group; lines that say more) of a traced window."""
        records = [r for r, _ in window['pieces']]
        done = {k: sum(r[k] for r in records)
                for k in ('epochs', 'steps', 'rows')}
        timed = [r['untraced_s'] for r in records]
        done['untraced_s'] = None if None in timed else sum(timed)
        launches, work = {}, {}
        for r in records:
            for k, n in r['launches'].items():
                launches[k] = launches.get(k, 0) + n
            for g, w in self.step_work(r).items():
                work[g] = work[g] + w if g in work else w
        return done, launches, work, []

    def judge(self, reference, device):
        """The checks' numbers against the plain `reference` module, and
        lines that say what the reference found."""
        numbers, info = common.judge(
            reference, self.inputs_,
            [self.to_tensors(s, device) for s in self.first], device)
        lines = ['reference, first steps: {0} ties to rounding taken on '
                 'the program\'s side'.format(info['ties_flipped'])]
        late, rows = common.judge_late(reference, self.inputs_, self.pre,
                                       self.late, device)
        for (prog_n, ref_n, ties), (_, key) in zip(rows, self.late):
            lines.append(
                'reference, late step {0} ({1} rows): {2} ties taken on the '
                'program\'s side{3}'.format(
                    key['it'], len(key['rows']), ties,
                    '' if ref_n is None else '; mean-field sweeps: program '
                    '{0}, reference {1}'.format(prog_n, ref_n)))
        if 'late_n_mf_gap' in late:
            lines.append('late_n_mf_gap (printed, not compared): {0}'.format(
                late['late_n_mf_gap']))
        numbers.update(late)
        return numbers, lines

    # ---- the model's steps ----------------------------------------------
    def fit(self, X, epochs):
        self.model.max_epoch = self.epochs_done + int(epochs)
        self.model.fit(X, self.X_val)
        sync(self.device)
        self.fits += 1
        self.epochs_done += int(epochs)
        self.steps_done += int(epochs) * -(-len(X) // self.B)

    def first_steps(self):
        """Steps 1 and 2-3 through ``fit``; the host copies of the state
        after each."""
        B = self.B
        self.fit(self.X[:B], 1)
        s1 = self.snapshot()
        self.fit(self.X[B:3 * B], 1)
        return s1, self.snapshot()

    def warm(self):
        """The warm-up: a ``fit`` call on the whole data of as many epochs
        as take every path the window takes (validation, the free-energy
        gap, a step that logs the train metrics), a multiple of the
        period; returns its seconds an epoch and its epochs."""
        steps = sum(n for _, n in self.batch_counts())
        every = int(self.metrics_every)
        to_log = every - self.steps_done % every
        epochs = self.period * -(-max(1, -(-to_log // steps)) //
                                 self.period)
        t0 = time.perf_counter()
        self.fit(self.X, epochs)
        return (time.perf_counter() - t0) / epochs, epochs

    def epochs_for(self, seconds, epoch_s):
        """The window's epochs: as many as fill `seconds` at the cell's
        nominal `epoch_s` seconds an epoch, a multiple of the period.  A
        fixed count, so that every run of a cell does the same work."""
        n = max(1, int(round(seconds / (epoch_s * self.period))))
        return n * self.period

    def batch_counts(self):
        """(rows, steps) of an epoch's steps: the full batches, then the
        remainder."""
        n_full, rem = divmod(len(self.X), self.B)
        return [(self.B, n_full)] + ([(rem, 1)] if rem else [])

    def run_epochs(self, epochs):
        """A ``fit`` call of `epochs` epochs on the whole data; returns
        what it did: its epochs, steps, training rows and the steps before
        and after it."""
        iter0 = self.steps_done
        self.fit(self.X, epochs)
        return {'epochs': epochs, 'steps': self.steps_done - iter0,
                'rows': epochs * len(self.X), 'iter0': iter0,
                'iter1': self.steps_done}

    def window(self, epochs):
        """The timed window: one ``fit`` call of `epochs` epochs."""
        return self.run_epochs(epochs)

    def traced_window(self, epochs, plan, traced):
        """The traced window: the same `epochs` as the pieces of `plan`
        (``trace_plan``), the slice of each run under `traced(fn)`, which
        returns fn's result and its trace.  Returns the whole window's
        record, with ``pieces``: (record, trace) of each traced slice, the
        record holding the seconds of its piece's timed part
        (``untraced_s``, None where it has none)."""
        iter0, pieces = self.steps_done, []
        for untraced, timed, n in plan:
            if untraced:
                self.run_epochs(untraced)
            seconds = None
            if timed:
                t0 = time.perf_counter()
                self.run_epochs(timed)
                seconds = time.perf_counter() - t0
            record, trace = traced(lambda: self.run_epochs(n))
            record['untraced_s'] = seconds
            pieces.append((record, trace))
        return {'epochs': epochs, 'steps': self.steps_done - iter0,
                'rows': epochs * len(self.X), 'iter0': iter0,
                'iter1': self.steps_done, 'pieces': pieces}

    def late_batches(self):
        """The late check's batches: rows after the first steps', a full
        batch, then one of the remainder's size where an epoch ends in one
        (else a second full batch)."""
        B = self.B
        rem = len(self.X) % B or B
        return [self.X[3 * B:4 * B], self.X[4 * B:4 * B + rem]]

    def late_steps(self):
        """The late check's steps, from the state the window left: one
        ``fit`` call a step.  Returns the host copy of the state before
        them and, for each, (the state after it, what keys its draws)."""
        pre, steps = self.snapshot(), []
        for rows in self.late_batches():
            key = {'fit': self.fits, 'epoch': self.epochs_done + 1,
                   'it': self.steps_done + 1, 'rows': rows}
            self.fit(rows, 1)
            steps.append((self.snapshot(), key))
        return pre, steps

    def end_to_end(self, window, wall):
        """The cell's end-to-end values from the timed window."""
        return {'train_samples_per_s': window['rows'] / wall}

    def snapshot(self):
        """A host copy of the model's state, under the reference's names."""
        arrays = self.model.get_params_arrays()
        return {k: arrays[v] for k, v in self.STATE.items()}

    def step_work(self, record):
        """The work of the training steps of a ``run_epochs`` record by
        kernel group."""
        out = {}
        for rows, count in self.batch_counts():
            for group, w in self.work_of_step(rows, record).items():
                out[group] = out.get(group, 0. * w) + count * w
        return {g: w * record['epochs'] for g, w in out.items()}

    @staticmethod
    def to_tensors(snapshot, device):
        return {k: torch.as_tensor(v, device=device)
                for k, v in snapshot.items()}

    def free(self):
        """Drop the model and its device state (the checks' host copies
        stay)."""
        self.model = None

    def schedule(self, key):
        spec = self.config[key]
        if isinstance(spec, dict):
            return list(np.geomspace(*spec['geomspace']))
        return [spec]
