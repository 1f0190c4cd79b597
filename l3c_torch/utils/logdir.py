"""Experiment log-dir names: create a unique log dir, find one, parse its
configs back.

Port of `l3c_tpu/utils/logdir.py`: a log dir is named
'MMDD_HHMM msconfig dlconfig [r@DATE] [postfix...]', so the tester
recovers the experiment's config files from the directory name alone;
creating one bumps the minute on a collision (an atomic mkdir is the
test).
"""
from __future__ import annotations

import datetime
import os
import re
from typing import List, Optional, Tuple

_SEP = " "
_DATE_FMT = "%m%d_%H%M"
_DATE_RE = re.compile(r"^\d{4}_\d{4}$")


def create_unique_log_dir(log_dir_root: str, config_paths: List[str],
                          postfix: Optional[List[str]] = None,
                          restore_dir: Optional[str] = None) -> str:
    """Create 'MMDD_HHMM cfg1 cfg2 [r@DATE] [postfix]' under root."""
    os.makedirs(log_dir_root, exist_ok=True)
    comps = [_strip_cf(p) for p in config_paths]
    if restore_dir:
        comps.append("r@" + log_date_from_log_dir(restore_dir))
    if postfix:
        comps.extend(postfix)
    when = datetime.datetime.now()
    while True:
        path = os.path.join(log_dir_root, _SEP.join(
            [when.strftime(_DATE_FMT)] + comps))
        try:
            os.makedirs(path)
            return path
        except FileExistsError:
            when += datetime.timedelta(minutes=1)


def _strip_cf(p: str) -> str:
    base = os.path.basename(p)
    return base[:-3] if base.endswith(".cf") else base


def log_date_from_log_dir(log_dir: str) -> str:
    name = os.path.basename(os.path.normpath(log_dir))
    date = name.split(_SEP)[0]
    if not _DATE_RE.match(date):
        raise ValueError(f"cannot parse log date from {log_dir!r}")
    return date


def parse_log_dir(log_dir: str, config_roots: List[str]
                  ) -> Tuple[str, List[str]]:
    """Recover (log_date, [config paths]) from a log dir name by searching
    the config roots for matching .cf files; components that name no
    config (r@DATE, postfixes) are skipped."""
    name = os.path.basename(os.path.normpath(log_dir))
    parts = name.split(_SEP)
    date, comps = parts[0], parts[1:]
    if not _DATE_RE.match(date):
        raise ValueError(f"invalid log dir name {name!r}")
    found = []
    for comp in comps:
        if comp.startswith("r@") or not comp:
            continue
        for root in config_roots:
            cand = _find_cf(root, comp)
            if cand:
                found.append(cand)
                break
    return date, found


def _find_cf(root: str, stem: str) -> Optional[str]:
    for base, _, files in os.walk(root):
        if stem + ".cf" in files:
            return os.path.join(base, stem + ".cf")
    return None


def find_log_dir(log_dir_root: str, log_date: str) -> str:
    """Resolve a 'MMDD_HHMM' date (or unique prefix) to its log dir."""
    matches = [d for d in sorted(os.listdir(log_dir_root))
               if d.startswith(log_date)]
    if not matches:
        raise FileNotFoundError(
            f"no log dir starting with {log_date!r} in {log_dir_root}")
    if len(matches) > 1:
        raise ValueError(f"ambiguous log date {log_date!r}: {matches}")
    return os.path.join(log_dir_root, matches[0])
