"""Serving: the LM decode step and greedy decode loop, and the hardened
stencil ROI-query service.

Two front doors share this package, as in the JAX package:

- the LM path: the decode step and the batched greedy decode loop
  (serve_step.py, launch/serve.py's default mode);
- the stencil path: axis-aligned ROI queries over the curve-ordered
  block store — contiguous curve-range decomposition (roi.py) fronted by
  a deadline/retry/integrity-hardened service (service.py,
  ``launch/serve.py --stencil``).
"""

from .serve_step import greedy_decode, make_serve_step  # noqa: F401
from .roi import (  # noqa: F401
    ROI, StoreLayout, extract_roi, merge_blocks_to_ranges, ranges_to_blocks,
    roi_model, roi_to_ranges,
)
from .service import (  # noqa: F401
    FetchError, QUERY_STATUSES, QueryResult, StencilQueryService,
)
