"""Command-line launchers of the port (mirrors ``repro.launch``)."""
