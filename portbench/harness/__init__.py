"""The benchmark's general code: the run's skeleton (``core``), the
seeded inputs (``weights``, ``images``), the work counts and peaks
(``counts``, ``peaks``) and the trace's reduction (``trace``)."""
