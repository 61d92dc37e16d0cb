"""Command-line nodes: the legged demo, the multi-process launch and the
command terminals."""
