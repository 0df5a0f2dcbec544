"""A small synthetic star catalogue and tiny-size run settings for the tests."""

import numpy as np

TINY = (32, 18)


def write_catalogue(path: str, n: int = 40000, seed: int = 0) -> str:
    """A PPM catalogue of ``n`` random stars (upstream format): dense enough
    that tiny frames hit stars."""
    rng = np.random.default_rng(seed)
    rec = np.zeros(n, dtype=np.dtype([("ra", ">f8"), ("dec", ">f8"), ("spectral", "u1"),
                                      ("_pad1", "u1"), ("mag", ">i2"), ("_pad2", "V8")]))
    rec["ra"] = rng.uniform(0, 2 * np.pi, n)
    rec["dec"] = np.arcsin(rng.uniform(-1, 1, n))
    rec["spectral"] = rng.choice([ord(c) for c in "OBAFGKMX"], n)
    rec["mag"] = rng.integers(-2000, 3000, n)
    with open(path, "wb") as f:
        f.write(b"\x00" * 28 + rec.tobytes())
    return path


def overrides(workload: str, stars: str) -> dict:
    ov = {"size": TINY, "stars": stars, "trace_units": 2}
    if workload.endswith(".fit"):
        ov["steps"] = 4
    if workload.startswith("default-ani"):
        ov["frames"] = 4
    return ov
