"""The premise of the port's pyramid rules (``tod_tpu_torch/ops/image.py``:
Eigen's depth splits and oneDNN's kernels, as the reference's compiled
programs run them): this host has the reference host's CPU flags, L1d and
L2 sizes and at least the thread pool that decides alike. On another host
the reference's own pyramid follows another blocking, so every parity
test of features, models and detections would fail as a bare bit
mismatch; this test fails first and names the cause.

It only reads: ``/proc/cpuinfo``, ``/sys/devices/system/cpu/cpu0/cache``
and the process's CPU affinity; for the P3P's ``rsqrt`` it compiles a few
lines of C in a temporary directory and calls this host's ``rsqrtps``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from tod_tpu_torch.ops import image as timage

CACHE = Path("/sys/devices/system/cpu/cpu0/cache")
TOOLS = ("tools/fit_resize_order.py", "tools/fit_sift_order.py",
         "tools/fit_pyramid_shards.py")


def read_flags() -> set:
    """The CPU flags of the first processor in ``/proc/cpuinfo``."""
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        if line.startswith("flags"):
            return set(line.split(":", 1)[1].split())
    return set()


def _size(text: str) -> int:
    text = text.strip()
    scale = {"K": 1024, "M": 1024 ** 2, "G": 1024 ** 3}.get(text[-1:], 1)
    return int(text.rstrip("KMG")) * scale


def read_caches() -> dict:
    """{"L1d": bytes, "L2": bytes} of cpu0's data and unified caches."""
    found = {}
    for index in sorted(CACHE.glob("index*")):
        level = (index / "level").read_text().strip()
        kind = (index / "type").read_text().strip()
        if kind in ("Data", "Unified") and level in ("1", "2"):
            found["L1d" if level == "1" else "L2"] = _size(
                (index / "size").read_text())
    return found


def read_threads() -> int:
    return len(os.sched_getaffinity(0))


def premise_failures(flags: set, caches: dict, threads: int) -> list:
    """Each premise of ``ops/image.py``'s constants this host breaks."""
    failed = [f"CPU flag {flag} missing from /proc/cpuinfo"
              for flag in timage._HOST_FLAGS if flag not in flags]
    for name, want in (("L1d", timage._L1), ("L2", timage._L2)):
        if caches.get(name) != want:
            failed.append(f"{name} cache {caches.get(name)} bytes, the rules "
                          f"take {want}")
    if threads < timage._POOL_ALIKE:
        failed.append(f"{threads} CPUs in this process's affinity, fewer "
                      f"than the {timage._POOL_ALIKE} whose thread pool "
                      "decides alike")
    return failed


def premise_message(failed: list) -> str:
    return ("this host is not the pyramid rules' premise: "
            + "; ".join(failed)
            + ". On it the reference's pyramid follows another blocking "
            "(Eigen's depth splits and oneDNN's kernels are chosen by the "
            "host), so the port's pyramid bits no longer match it. Rerun "
            "with the JAX package on this host: " + ", ".join(TOOLS)
            + " (JAX_PLATFORMS=cpu), and refit ops/image.py's rules.")


def check_premise(flags: set, caches: dict, threads: int) -> None:
    failed = premise_failures(flags, caches, threads)
    if failed:
        pytest.fail(premise_message(failed), pytrace=False)


def test_host_is_the_pyramids_premise():
    check_premise(read_flags(), read_caches(), read_threads())


@pytest.mark.parametrize("flags, caches, threads, named", [
    ({"fma"}, {"L1d": 48 * 1024, "L2": 2 << 20}, 8, "avx512f"),
    ({"avx512f", "fma"}, {"L1d": 32 * 1024, "L2": 2 << 20}, 8, "L1d"),
    ({"avx512f", "fma"}, {"L1d": 48 * 1024, "L2": 1 << 20}, 8, "L2"),
    ({"avx512f", "fma"}, {"L1d": 48 * 1024, "L2": 2 << 20}, 4, "4 CPUs")])
def test_premise_failure_names_its_cause(monkeypatch, flags, caches, threads,
                                         named):
    """The failing branch, forced through the readers: one message naming
    the premise, the blocking it moves and the tools to rerun."""
    module = sys.modules[__name__]
    monkeypatch.setattr(module, "read_flags", lambda: flags)
    monkeypatch.setattr(module, "read_caches", lambda: caches)
    monkeypatch.setattr(module, "read_threads", lambda: threads)
    with pytest.raises(pytest.fail.Exception) as failure:
        test_host_is_the_pyramids_premise()
    text = str(failure.value)
    assert named in text and "another blocking" in text
    assert all(tool in text for tool in TOOLS)


def test_readers_parse_this_host():
    """The readers return what the premise needs: flags, both cache sizes
    in bytes and a positive CPU count."""
    assert read_flags() and read_threads() >= 1
    assert set(read_caches()) == {"L1d", "L2"}
    assert _size("48K") == 48 * 1024 and _size("2048K") == 2 << 20


# The premise of the port's LAPACK readings (geometry/lapack.py lu_solve and
# syevd3, kernels P1, P2, M2): jnp.linalg.solve and eigh run scipy's OpenBLAS,
# whose BLAS kernels (and so whose rounding) depend on its version and on
# the core it selects for this CPU.
OPENBLAS = ("0.3.30", "SkylakeX")
LAPACK_TOOL = "tools/fit_lapack_order.py"


def read_openblas():
    """(version, core) of the OpenBLAS that scipy's LAPACK loads, as
    threadpoolctl reports it (None if none is loaded)."""
    import scipy.linalg.lapack  # noqa: F401  loads scipy's OpenBLAS
    from threadpoolctl import threadpool_info
    for lib in threadpool_info():
        if lib.get("internal_api") == "openblas" \
                and "scipy" in Path(lib["filepath"]).parent.name:
            return lib.get("version"), lib.get("architecture")
    return None


def lapack_premise_message(found) -> str:
    return (f"scipy's OpenBLAS is {found}, not {OPENBLAS}: the reference's "
            "jnp.linalg.solve and eigh round as this library's BLAS kernels "
            "do, so the port's LU and eigenvector no longer match them. "
            f"Rerun JAX_PLATFORMS=cpu python {LAPACK_TOOL} on this host and "
            "refit geometry/lapack.py.")


def test_host_is_the_lapack_premise():
    found = read_openblas()
    if found != OPENBLAS:
        pytest.fail(lapack_premise_message(found), pytrace=False)


@pytest.mark.parametrize("found", [("0.3.27", "SkylakeX"),
                                   ("0.3.30", "Haswell"), None])
def test_lapack_premise_failure_names_its_cause(monkeypatch, found):
    module = sys.modules[__name__]
    monkeypatch.setattr(module, "read_openblas", lambda: found)
    with pytest.raises(pytest.fail.Exception) as failure:
        test_host_is_the_lapack_premise()
    assert LAPACK_TOOL in str(failure.value)
    assert str(found) in str(failure.value)


# the P3P's rsqrt (ops/rsqrtps.py, kernel P1): XLA emits it as this host's
# rsqrtps estimate, whose table the port carries as data
RSQRT_TOOL = "tools/fit_p3p_fusions.py"


def read_rsqrtps():
    """This host's ``rsqrtps`` results for 2^p (1 + m / 1024), p = 0, 1, as
    (2048,) uint32 (a few lines of C compiled with gcc and called), or
    None where gcc or AVX is missing."""
    tools = str(Path(__file__).resolve().parents[1] / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import fit_p3p_fusions as fus
    try:
        return fus.rsqrtps_table().reshape(-1)
    except (OSError, subprocess.CalledProcessError):
        return None


def rsqrt_premise_message() -> str:
    return ("this host's rsqrtps is not the reference host's "
            "(ops/rsqrtps.py RSQRTPS_TABLE): the reference's P3P takes "
            "its resolvent's arccos argument through XLA's rsqrt, which "
            "is this instruction and two Newton steps, so its roots round "
            f"otherwise. Rerun JAX_PLATFORMS=cpu python {RSQRT_TOOL} "
            "--oracle on this host and refresh the table.")


def test_host_is_the_rsqrt_premise():
    import numpy as np

    from tod_tpu_torch.ops.rsqrtps import RSQRTPS_TABLE

    found = read_rsqrtps()
    if found is None or not np.array_equal(found, RSQRTPS_TABLE):
        pytest.fail(rsqrt_premise_message(), pytrace=False)


def test_rsqrt_premise_failure_names_its_cause(monkeypatch):
    import numpy as np

    module = sys.modules[__name__]
    monkeypatch.setattr(module, "read_rsqrtps",
                        lambda: np.zeros(2048, np.uint32))
    with pytest.raises(pytest.fail.Exception) as failure:
        test_host_is_the_rsqrt_premise()
    assert RSQRT_TOOL in str(failure.value)
