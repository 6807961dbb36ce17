"""Model configurations of the port: the ten architectures of
``repro.configs`` as data (``base``, one module an architecture) and the
``registry`` that maps ``--arch <id>`` to a config and a model API."""
