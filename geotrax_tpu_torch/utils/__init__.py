"""Host helpers of the CLI: logging, shared arguments, configuration, paths."""
