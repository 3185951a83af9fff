"""REST application, ASGI framework and HTTP server."""
