"""The serving front door: the OpenAI HTTP plane (``http_server``),
single-host serving (``serve``) and offline generation (``generate``)."""
