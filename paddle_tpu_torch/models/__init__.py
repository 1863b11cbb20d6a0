"""Models of the port: the GPT (``gpt``: functional and eager faces) and
LeNet."""
from .lenet import LeNet  # noqa: F401
