"""Host utilities of the CLI: media input/output (`media`), the
foreground/background edit masks (`masks`) and timing (`timing`)."""
