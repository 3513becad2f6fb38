#!/usr/bin/env python
"""Deterministic repo policy gates (the reference's check_policies.py
discipline, scripts/check_policies.py:12-18 — adapted to this codebase).

Checks:
  1. single-getenv-site — all environment access in the package goes
     through utils/env_knobs.py (the reference's env-knob registry policy).
  2. knob-registry-consistency — every env_knobs.get() key in the package
     is a registered Knob, and every registered knob is documented in the
     module docstring.
  3. no-reference-reads — nothing in the package reads the reference tree
     at runtime (tests and tooling may; the library must be standalone).
  4. knob-consumption — every registered knob has at least one
     env_knobs.get() consumer inside the package: a knob with no consumer
     is documented capability that does not exist.

Exit code 0 = all green. Run from the repo root (CI / pre-commit).
"""

from __future__ import annotations

import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ice_halo_sim_jax")

failures = []


def fail(check: str, msg: str) -> None:
    failures.append(f"[{check}] {msg}")


def pkg_files():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def check_single_getenv_site():
    pat = re.compile(r"os\.environ|os\.getenv|getenv\(")
    # JAX/XLA platform plumbing is runtime-host config, not a renderer
    # knob; the policy guards IHT_* knob access only.
    exempt = re.compile(r"os\.environ\[\s*[\"']((JAX|XLA)_)")
    for path in pkg_files():
        rel = os.path.relpath(path, REPO)
        if rel.endswith("utils/env_knobs.py"):
            continue
        for i, line in enumerate(open(path), 1):
            if line.lstrip().startswith("#"):
                continue
            if pat.search(line) and "env_knobs" not in line \
                    and not exempt.search(line):
                fail("single-getenv-site",
                     f"{rel}:{i}: raw environment access: {line.strip()}")


def check_knob_registry():
    sys.path.insert(0, REPO)
    from ice_halo_sim_jax.utils import env_knobs

    registered = set(env_knobs.KNOBS)
    doc = open(os.path.join(PKG, "utils", "env_knobs.py")).read()
    for name in registered:
        if doc.count(name) < 2:  # Knob entry + docstring mention
            fail("knob-registry", f"{name} registered but not documented "
                                  "in the module docstring")
    pat = re.compile(r"env_knobs\.get\(\s*[\"'](\w+)[\"']")
    for path in pkg_files():
        rel = os.path.relpath(path, REPO)
        for i, line in enumerate(open(path), 1):
            m = pat.search(line)
            if m and m.group(1) not in registered:
                fail("knob-registry",
                     f"{rel}:{i}: unregistered knob {m.group(1)!r}")


def check_knob_consumption():
    sys.path.insert(0, REPO)
    from ice_halo_sim_jax.utils import env_knobs

    pat = re.compile(r"env_knobs\.get\(\s*[\"'](\w+)[\"']")
    consumed = set()
    for path in pkg_files():
        if path.endswith("utils/env_knobs.py"):
            continue
        for line in open(path):
            m = pat.search(line)
            if m:
                consumed.add(m.group(1))
    for name in env_knobs.KNOBS:
        if name not in consumed:
            fail("knob-consumption",
                 f"{name} is registered/documented but consumed nowhere in "
                 "the package — wire it or drop it")


def check_no_reference_reads():
    for path in pkg_files():
        rel = os.path.relpath(path, REPO)
        for i, line in enumerate(open(path), 1):
            # Docstring/comment citations are REQUIRED (parity traceability);
            # only actual file ACCESS of the reference tree is banned.
            if "/root/reference" in line and re.search(
                    r"open\(|load\(|Path\(|read_", line):
                fail("no-reference-reads", f"{rel}:{i}: {line.strip()}")


def main() -> int:
    check_single_getenv_site()
    check_knob_registry()
    check_knob_consumption()
    check_no_reference_reads()
    if failures:
        print(f"POLICY FAILURES ({len(failures)}):")
        for f in failures:
            print("  " + f)
        return 1
    print("all policies green")
    return 0


if __name__ == "__main__":
    sys.exit(main())
