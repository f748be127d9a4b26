"""Wall-clock context-manager timer (reference utils/stopwatch.py:5-64 analog)."""

import time


class Stopwatch(object):
    """
    Examples
    --------
    >>> with Stopwatch(verbose=False) as s:
    ...     _ = sum(range(1000))
    >>> s.elapsed() >= 0.
    True
    """

    def __init__(self, verbose=False):
        self.verbose = verbose
        self._start = None
        self._elapsed = None

    def start(self):
        self._start = time.time()
        self._elapsed = None
        return self

    def stop(self):
        if self._start is not None:
            self._elapsed = time.time() - self._start
        return self

    def elapsed(self):
        if self._elapsed is not None:
            return self._elapsed
        if self._start is not None:
            return time.time() - self._start
        return None

    def __enter__(self):
        return self.start()

    def __exit__(self, *args):
        self.stop()
        if self.verbose:
            print('Elapsed time: {0:.3f} sec'.format(self._elapsed))
