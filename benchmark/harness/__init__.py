"""The benchmark's own code: the traffic generator (``traffic``), the
lookup of files by name (``lookup``), the reading of a profiler trace
(``trace``), the correctness comparison (``check``), the device peaks
(``peaks``) and the run itself (``cell``). No module here imports the
program at its own import: the clients under ``entries/`` import it when
one is built, and ``cell`` when it builds the kernels."""
