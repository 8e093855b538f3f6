"""Stubs of the LLMService protocol (``llm.proto``): the benchmark's
own copy."""
