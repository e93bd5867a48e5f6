"""Host-side cluster pieces of the port: the checkpoint library
(``checkpoint``) and the historical streaming entry point (``runner``)."""
