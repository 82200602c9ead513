"""Find a cell's files by the names in ``BENCHMARK.json``.

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix, read by its maker;
- ``makers/<maker>.py``: how a mix's data is made and stored, named by the
  traffic file's ``maker`` (:meth:`Bench.maker`);
- ``pipelines/<config>.py``: the pipeline, written against the port's API;
- ``reference/<config>.py``: its plain reference;
- ``metrics/<metric>.py``: one reader a metric.

A later change adds a configuration, a mix, a data shape or a metric by
adding files and entries; nothing here names one.
"""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

def _json(path):
    with open(path) as f:
        return json.load(f)


def load_module(kind, name, here=HERE):
    """``<kind>/<name>.py`` as a module (names may hold ``.`` and ``-``)."""
    path = os.path.join(here, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError("no {} file for {!r}: {}".format(
            kind, name, path))
    spec = importlib.util.spec_from_file_location(
        "portbench_{}_{}".format(kind, name.replace(".", "_").replace(
            "-", "_")), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench(object):
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root=ROOT):
        self.root = root
        self.here = os.path.join(root, os.path.basename(HERE))
        self.doc = _json(os.path.join(root, "BENCHMARK.json"))

    def module(self, kind, name):
        return load_module(kind, name, self.here)

    def cell(self, workload):
        for w in self.doc["workloads"]:
            if w["name"] == workload:
                return w
        raise KeyError("no workload {!r} in BENCHMARK.json (cells: {})"
                       .format(workload, ", ".join(
                           w["name"] for w in self.doc["workloads"])))

    def config(self, name):
        for c in self.doc["configs"]:
            if c["name"] == name:
                return _json(os.path.join(self.root, c["file"]))
        raise KeyError("no config {!r} in BENCHMARK.json".format(name))

    def traffic(self, name):
        return _json(os.path.join(self.here, "traffic", name + ".json"))

    def maker(self, traffic):
        """The module that makes ``traffic``'s data: ``makers/<maker>.py``.

        Its one function, ``make(traffic, seed, work_dir, bench)``, writes
        the data for ``seed`` under ``work_dir`` and returns a dict:

        - ``input``: the pipeline's first argument, one path or a dict of
          names to paths (a configuration that reads several inputs);
        - ``bytes``: the record bytes a job reads (text uncompressed), the
          denominator of every per-MB metric;
        - ``stored_bytes``: the bytes on disk, which the harness cuts into
          the configuration's ``chunks``;
        - ``truth``: a tuple; the reference is called as
          ``expected(*truth)``, ``work(*truth)`` and ``control(*truth)``;
        - ``about`` (optional): a dict of what else the run prints and
          keeps of the data (copies, members, ...).
        """
        return self.module("makers", traffic["maker"])

    def metrics(self, workload, trace):
        """The metric entries a cell reports: its end-to-end metrics
        untraced, its per-layer metrics traced."""
        entries = self.doc["per_layer" if trace else "end_to_end"]
        return [m for m in entries
                if "workloads" not in m or workload in m["workloads"]]
