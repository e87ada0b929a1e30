"""Host-side utilities of the port: ``preproc``, image preprocessing
through its own build of ``native/preproc.cpp``."""
