"""Device-side LIMS index builder (port of ``repro.build``).

The paper's build pipeline (§4: k-center clustering → FFT pivots →
per-(cluster, pivot) sorted distance columns → polynomial rank models →
rings/LIMS values → position models) expressed as batched torch over a
padded cluster-major layout on one device:

  ``cluster``   batched k-center / k-means sweeps over device distances
  ``pivots``    FFT pivot selection as device argmax sweeps + distance
                columns through the ``pdist`` kernels (sql2, l1, linf)
  ``fit``       all K·m rank-model fits plus the K position-model fits
                as ONE batched Chebyshev-Vandermonde normal-equations
                solve, with a device-side certified rank-error estimate
  ``builder``   orchestration, the exact host materialization that
                ``LIMSIndex(backend="device")`` consumes, and the
                single-cluster retrain path of ``retrain_cluster``

Exactness contract: the device does the heavy lifting (clustering,
pivot selection, model fitting); every quantity exactness depends on
(pivot-distance columns, TriPrune extents, ring boundaries, certified
error bounds) is recomputed exactly on the host from the device's
structural choices.  Device-fit models are only ever *accelerators*:
the host path corrects them with exponential search, the snapshot path
re-certifies E against the exact columns.
"""
from .builder import (DeviceBuildResult, build_index, build_snapshot,
                      device_build, retrain_device)
from .cluster import cluster_major, device_kcenter, device_kmeans
from .fit import batched_chebfit

__all__ = [
    "DeviceBuildResult", "device_build", "build_index", "build_snapshot",
    "retrain_device", "device_kcenter", "device_kmeans", "cluster_major",
    "batched_chebfit",
]
