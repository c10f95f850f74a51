"""Hand-written Pallas kernels for the framework's hot ops.

``frame_kernel`` runs the tracking frame loop as one Triton-route kernel
per sequence; its plain-JAX reference is the ``lax.scan`` over
``models/pipeline.frame_step`` (``VOConfig.scan_backend="xla"``), and the
tests compare the two through the Pallas interpreter.
"""

from . import frame_kernel  # noqa: F401
