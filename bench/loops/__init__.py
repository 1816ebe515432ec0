"""The loops that serve a traffic mix, one module each, named by the
``loop`` key of a ``bench/traffic/<traffic>.json``."""
