"""The port's server: a protocol-independent core, a model repository and
an HTTP/1.1 front-end with OpenAI-compatible routes."""
