"""Launchers of the port: serving (``launch/serve.py``), training
(``launch/train.py``), meshes (``launch/mesh.py``), and the shape grid's
analytic estimates and roofline terms (``launch/estimates.py``,
``launch/roofline.py``)."""
