"""The metric registry and ``calc_metric`` (port of
gagan_tpu/metrics/metric_main.py): the JAX registry's 15 names, the
``fid<N>k`` / ``kid<N>k`` families, and ``report_metric`` appending to
``metric-<name>.jsonl`` with the same keys."""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict

from . import feature_stats as fs
from . import fid as fid_lib
from . import inception_score as is_lib
from . import kid as kid_lib
from . import ppl as ppl_lib
from . import precision_recall as pr_lib

_metric_dict: Dict[str, Any] = {}


def register_metric(fn):
    assert callable(fn)
    _metric_dict[fn.__name__] = fn
    return fn


# Parametric families: fid<N>k and kid<N>k for any N.
_PARAMETRIC = re.compile(r"^(fid|kid)([0-9]+)k$")


def is_valid_metric(metric: str) -> bool:
    return metric in _metric_dict or _PARAMETRIC.match(metric) is not None


def list_valid_metrics():
    return list(_metric_dict.keys())


def calc_metric(metric: str, **kwargs) -> Dict[str, Any]:
    """``kwargs`` are MetricOptions' fields (``device`` among them)."""
    assert is_valid_metric(metric), f"unknown metric {metric}"
    opts = fs.MetricOptions(**kwargs)
    start_time = time.time()
    m = _PARAMETRIC.match(metric)
    if m and metric not in _metric_dict:
        kind, n = m.group(1), int(m.group(2)) * 1000
        if kind == "fid":
            results = {metric: fid_lib.compute_fid(opts, max_real=None,
                                                   num_gen=n)}
        else:
            results = {metric: kid_lib.compute_kid(opts, max_real=n,
                                                   num_gen=n)}
    else:
        results = _metric_dict[metric](opts)
    total_time = time.time() - start_time
    return dict(
        results=results,
        metric=metric,
        total_time=total_time,
        total_time_str=f"{total_time:.1f}s",
        num_gpus=1,
    )


def report_metric(result_dict, run_dir=None, snapshot_pkl=None):
    """Print the result's JSON line and append it to
    ``<run_dir>/metric-<name>.jsonl``."""
    metric = result_dict["metric"]
    if snapshot_pkl is not None and run_dir is not None:
        snapshot_pkl = os.path.relpath(snapshot_pkl, run_dir)
    jsonl_line = json.dumps(dict(
        result_dict, snapshot_pkl=snapshot_pkl, timestamp=time.time()))
    print(jsonl_line)
    if run_dir is not None and os.path.isdir(run_dir):
        with open(os.path.join(run_dir, f"metric-{metric}.jsonl"), "at") as f:
            f.write(jsonl_line + "\n")
    return result_dict


# ----------------------------------------------------------------------------
# Registrations.


@register_metric
def fid50k_full(opts):
    return {"fid50k_full": fid_lib.compute_fid(opts, max_real=None,
                                               num_gen=50000)}


@register_metric
def fid50k(opts):
    return {"fid50k": fid_lib.compute_fid(opts, max_real=50000,
                                          num_gen=50000)}


@register_metric
def fid10k(opts):
    return {"fid10k": fid_lib.compute_fid(opts, max_real=10000,
                                          num_gen=10000)}


@register_metric
def fid5k(opts):
    return {"fid5k": fid_lib.compute_fid(opts, max_real=5000, num_gen=5000)}


@register_metric
def kid5k(opts):
    return {"kid5k": kid_lib.compute_kid(opts, max_real=5000, num_gen=5000)}


@register_metric
def kid50k_full(opts):
    return {"kid50k_full": kid_lib.compute_kid(
        opts, max_real=1000000, num_gen=50000)}


@register_metric
def kid50k(opts):
    return {"kid50k": kid_lib.compute_kid(opts, max_real=50000,
                                          num_gen=50000)}


@register_metric
def pr50k3_full(opts):
    precision, recall = pr_lib.compute_pr(opts, max_real=200000,
                                          num_gen=50000)
    return {"pr50k3_full_precision": precision,
            "pr50k3_full_recall": recall}


@register_metric
def pr50k3(opts):
    precision, recall = pr_lib.compute_pr(opts, max_real=50000,
                                          num_gen=50000)
    return {"pr50k3_precision": precision, "pr50k3_recall": recall}


def _ppl(opts, space, sampling, crop):
    return ppl_lib.compute_ppl(opts, num_samples=50000, epsilon=1e-4,
                               space=space, sampling=sampling, crop=crop)


@register_metric
def ppl2_wend(opts):
    return {"ppl2_wend": _ppl(opts, "w", "end", crop=False)}


@register_metric
def ppl_zfull(opts):
    return {"ppl_zfull": _ppl(opts, "z", "full", crop=True)}


@register_metric
def ppl_wfull(opts):
    return {"ppl_wfull": _ppl(opts, "w", "full", crop=True)}


@register_metric
def ppl_zend(opts):
    return {"ppl_zend": _ppl(opts, "z", "end", crop=True)}


@register_metric
def ppl_wend(opts):
    return {"ppl_wend": _ppl(opts, "w", "end", crop=True)}


@register_metric
def is50k(opts):
    mean, std = is_lib.compute_is(opts, num_gen=50000, num_splits=10)
    return {"is50k_mean": mean, "is50k_std": std}
