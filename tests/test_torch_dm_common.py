"""Shared part of the data-maintenance tests (tests/test_torch_ddl.py,
test_torch_refresh.py, test_torch_maintenance.py and
test_torch_maintenance_cli.py): the port's CPU warehouse at ``SCALE``
(``ndstpu_torch.datagen.generate(SCALE, seed=1)``, the corpus
differential's), its refresh set 1, sessions of both packages over forks
of it, and the JAX generator's refresh files.  Statements
replace catalog tables and never write one, so each test forks the
module's warehouse: a new catalog holding the same tables.  This module
holds no tests itself."""

import os
import subprocess

from ndstpu.check import check_build
from ndstpu.io import loader
from ndstpu_torch import datagen
from ndstpu_torch.engine.session import Session
from ndstpu_torch.io.catalog import Catalog
from test_torch_corpus_common import jax_reference

SCALE = 0.01
SEED = 1
UPDATE = 1
# the functions that fail in the JAX package at planner.py:257 (their
# left join time_dim on t_time = 43200), and in the port alike
FAILING = ("LF_CR", "LF_SR", "LF_WR")


def warehouse(refresh: bool = True) -> Catalog:
    """The port's CPU warehouse at ``SCALE``, with refresh set
    ``UPDATE`` registered."""
    cat = datagen.generate(SCALE, seed=SEED, device="cpu")
    if refresh:
        for name, t in datagen.generate_refresh(SCALE, UPDATE, SEED,
                                                "cpu").items():
            cat.register(name, t)
    return cat


def fork(cat: Catalog) -> Catalog:
    """A catalog holding ``cat``'s tables, registered apart."""
    return Catalog(tables=dict(cat.tables), meta=dict(cat.meta),
                   versions=dict(cat.versions))


def fork_jax(cat: loader.Catalog) -> loader.Catalog:
    return loader.Catalog(tables=dict(cat.tables), meta=dict(cat.meta),
                          versions=dict(cat.versions))


def sessions(cat: Catalog, jcat: loader.Catalog):
    """(JAX session, port session) over forks of one warehouse."""
    return (jax_reference(fork_jax(jcat)), Session(fork(cat), device="cpu"))


def ndsgen_refresh(out_dir, sf: float = SCALE, update: int = UPDATE):
    """The JAX package's C++ generator's refresh set ``update`` at
    ``sf``, written as ``<table>_1_1.dat`` files into ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    subprocess.run([str(check_build()), "-scale", str(sf), "-dir",
                    str(out_dir), "-update", str(update)], check=True,
                   capture_output=True)
    return out_dir
