SELECT id1, sum(v1) AS v1 FROM source GROUP BY id1;
