"""Host-side utilities of the port: ``preproc``, image preprocessing
through its own build of ``native/preproc.cpp``; ``debug``, the debugging
tools (``plain_mode``, ``checked_execute``, ``check_finite``,
``compare_backends``, ``compare_shardings``)."""
