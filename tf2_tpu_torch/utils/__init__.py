"""Host-side utilities of the port: ``preproc``, image preprocessing
through its own build of ``native/preproc.cpp``; ``debug``, the per-node
check of a meshed Engine's partition (``compare_shardings``)."""
