"""The harness that runs one cell of `BENCHMARK.json`: the spec it reads
(`spec`), the generator of every traffic mix (`traffic`), the runners
of the program's entries (`runners`), the reduction of a profiler trace
(`trace`) and the run itself (`main`)."""
