"""Observability of the serving path: the metrics registry (``registry``),
the flight recorder (``flightrec``), request tracing (``tracing``) and
profiler spans (``spans``). The first three are copies of the JAX
package's framework-free modules; the rest of ``tpunet/obs`` (health,
MFU, memory gauges, the windowed profiler, exporters) is ROADMAP Queue A
item 7."""
