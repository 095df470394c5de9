"""Page orientation classifier (port of ``rapiddoc_tpu/models/orientation``)."""
