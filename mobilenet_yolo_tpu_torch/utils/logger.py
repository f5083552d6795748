"""Tab-separated training logger with resume support and plotting.

Same on-disk format and semantics as the reference utils/logger.py:28-107:
a ``log.txt`` with a tab-separated header, one row per append, resume-parse
of an existing file, and matplotlib plots of any subset of columns.

A copy of ``mobilenet_yolo_tpu/utils/logger.py``: stdlib only, matplotlib
imported where a plot is drawn.
"""

from __future__ import annotations

import os


class Logger:
    def __init__(self, fpath: str, title: str = "", resume: bool = False):
        self.file = None
        self.resume = resume
        self.title = title
        self.names: list[str] = []
        self.numbers: dict[str, list[float]] = {}
        if fpath is not None:
            if resume and os.path.isfile(fpath):
                with open(fpath, "r") as f:
                    name_line = f.readline().rstrip()
                    self.names = name_line.split("\t")
                    self.numbers = {n: [] for n in self.names}
                    for line in f:
                        vals = line.rstrip().split("\t")
                        for i, n in enumerate(self.names):
                            if i < len(vals) and vals[i] != "":
                                self.numbers[n].append(float(vals[i]))
                self.file = open(fpath, "a")
            else:
                self.file = open(fpath, "w")

    def set_names(self, names):
        if self.resume:
            return
        self.names = list(names)
        self.numbers = {n: [] for n in self.names}
        self.file.write("\t".join(self.names) + "\n")
        self.file.flush()

    def append(self, numbers):
        assert len(self.names) == len(numbers), "numbers do not match names"
        parts = []
        for n, v in zip(self.names, numbers):
            parts.append("{0:.6f}".format(float(v)))
            self.numbers[n].append(float(v))
        self.file.write("\t".join(parts) + "\n")
        self.file.flush()

    def plot(self, names=None):
        import matplotlib.pyplot as plt

        names = self.names if names is None else names
        for n in names:
            x = range(len(self.numbers[n]))
            plt.plot(x, self.numbers[n])
        plt.legend([self.title + "(" + n + ")" for n in names])
        plt.grid(True)

    def savefig(self, fname, names=None, dpi=150):
        import matplotlib
        matplotlib.use("Agg", force=True)
        import matplotlib.pyplot as plt

        plt.figure()
        self.plot(names)
        plt.savefig(fname, dpi=dpi)
        plt.close()

    def close(self):
        if self.file is not None:
            self.file.close()
            self.file = None


class LoggerMonitor:
    """Overlay plots of multiple runs (reference utils/logger.py:96-107)."""

    def __init__(self, paths: dict[str, str]):
        """paths: {run title: log.txt path}."""
        self.loggers = []
        for title, path in paths.items():
            self.loggers.append(Logger(path, title=title, resume=True))

    def plot(self, names=None):
        import matplotlib.pyplot as plt

        plt.grid(True)
        legend = []
        for logger in self.loggers:
            logger.plot(names)
            ns = logger.names if names is None else names
            legend += [f"{logger.title}({n})" for n in ns]
        plt.legend(legend)

    def savefig(self, fname, names=None, dpi=150):
        import matplotlib
        matplotlib.use("Agg", force=True)
        import matplotlib.pyplot as plt

        plt.figure()
        self.plot(names)
        plt.savefig(fname, dpi=dpi)
        plt.close()
