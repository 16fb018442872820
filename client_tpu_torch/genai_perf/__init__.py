"""The OpenAI front-end's tokenizer."""
