"""Server-side pieces of the port: access control and roles
(``security.py``). The HTTP statement server and its authenticators are
not ported."""
