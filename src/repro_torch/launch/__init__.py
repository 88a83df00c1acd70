"""Entry points of the port: LM batch serving and the simulation job
service (``launch.serve``), the segmented simulation launcher
(``launch.sim``) and the spool analysis (``launch.analyze``)."""
