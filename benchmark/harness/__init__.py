"""The benchmark's harness: cells found by name, the deployments built or
loaded, closed-loop clients on the dispatcher, the profiler's trace
reduced, and the frozen byte rules of the rooflines."""
