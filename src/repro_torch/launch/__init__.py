"""Entry points of the port: LM batch serving (``launch.serve``)."""
