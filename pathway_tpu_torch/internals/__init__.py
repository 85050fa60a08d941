"""The table API's model: dtypes, schemas, column expressions, ``pw.this``, tables,
UDFs, the capture graph and the runner that lowers it onto the engine."""
