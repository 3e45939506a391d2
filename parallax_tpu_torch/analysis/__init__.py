"""Static and runtime analysis (port of ``parallax_tpu/analysis``): only
``sanitizer.make_lock`` so far; the linter, checkers and the lock-order
sanitizer wait for ROADMAP queue 1 item 14."""
