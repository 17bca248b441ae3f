"""Model configurations of the language-model substrate (``base``) and the
ported architectures."""
