"""The one traffic generator: every mix is a data file it reads.

A mix (``traffic/<name>.json``) names the entry of the program that its
window drives (``"entry"``, the file ``entries/<entry>.py``) and that
entry's parameters; an open-loop mix also names its arrival law
(``"arrivals"``, the file ``arrivals/<law>.py``, whose ``times(mix,
seconds, rng)`` reads the law's parameters from the mix).  Every mix draws
its queries from the configuration's held-out pool, in an order drawn from
the seed.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from portbench import plugins
from portbench.data import derive_seed

HERE = pathlib.Path(__file__).resolve().parent


def load(name: str) -> dict:
    """The mix ``traffic/<name>.json``; its entry and arrival law must exist."""
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    entry(mix)
    if "arrivals" in mix:
        plugins.load("arrivals", mix["arrivals"], "arrival law")
    return mix


def entry(mix: dict):
    """The module of the mix's entry (``entries/<entry>.py``)."""
    return plugins.load("entries", str(mix.get("entry")), "entry")


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(derive_seed(seed, purpose))


def pool_order(pool_size: int, seed: int) -> np.ndarray:
    """The order in which the pool's queries are sent."""
    return rng(seed, "pool").permutation(pool_size)


def arrivals(mix: dict, seconds: float, seed: int, purpose: str = "arrivals") -> np.ndarray:
    """Open-loop arrival times in [0, seconds) of the mix's law, from the seed."""
    law = plugins.load("arrivals", mix["arrivals"], "arrival law")
    return law.times(mix, seconds, rng(seed, purpose))
